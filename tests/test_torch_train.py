"""The port's single-device GNN training on the CPU against the JAX package
(``repro.launch.train`` with ``mesh=None``): the same data, the same
parameters (the JAX init loaded with ``params_from_jax``), the same steps.

This file holds one partitioned sample's loss and gradients, remat, Adam,
the parameter conversion, nonfinite steps, and predict and eval; the
5-step trajectory and ``train_gnn`` are in ``test_torch_train_trajectory.py``
and ``test_torch_train_gnn*.py``. Size and set-up: ``_torch_train_common.py``
(``GNNConfig().reduced()`` with hidden 32, 2 message-passing layers, halo 2,
levels (64, 128, 256), 4 partitions). Everything runs in f32; the host data
pipeline is the same numpy code in both packages, so its arrays are
bit-equal. Tolerances are stated beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import (EVAL_TOL, GRAD_TOL, REMAT_TOL, SIZE,
                                 _close, _model, _np, _torch_batch,
                                 build_data)
from repro.launch import train as jtrain
from repro.models import meshgraphnet as jmgn
from repro.optim import adam as jadam
from repro_torch.core.gradient_aggregation import aggregate_gradients
from repro_torch.kernels.segment_agg import ref as seg_ref
from repro_torch.launch import train as ptrain
from repro_torch.models import meshgraphnet as mgn
from repro_torch.models.convert import adam_state_from_jax, params_to_jax
from repro_torch.optim import adam as padam


@pytest.fixture(scope="module")
def data():
    return build_data()


def test_dataset_and_partitions_equal_jax(data):
    """build_dataset and partition_samples: bit-equal arrays."""
    (jtr, jte, jni, jno), (ptr, pte, pni, pno) = data["jd"], data["pd"]
    assert [s.sample_id for s in jtr] == [s.sample_id for s in ptr]
    assert [s.sample_id for s in jte] == [s.sample_id for s in pte]
    for a, b in zip(jtr + jte, ptr + pte):
        np.testing.assert_array_equal(a.node_feats, b.node_feats)
        np.testing.assert_array_equal(a.targets, b.targets)
        for k in ("positions", "senders", "receivers", "normals",
                  "edge_feats", "level_of_edge"):
            np.testing.assert_array_equal(getattr(a.graph, k),
                                          getattr(b.graph, k))
    for a, b in ((jni, pni), (jno, pno)):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)
    for a, b in zip(data["jps"], data["pps"]):
        assert a.denom == b.denom and a.n_nodes == b.n_nodes
        assert sorted(a.stacked) == sorted(b.stacked)
        for k in a.stacked:
            np.testing.assert_array_equal(a.stacked[k], b.stacked[k])
        for k in a.padded:
            np.testing.assert_array_equal(a.padded[k], b.padded[k])
    # the padded batches hold masked padding edges (receiver 0)
    em = data["pps"][0].stacked["edge_mask"]
    assert (em == 0).any() and (em == 1).any()


def _jax_loss_and_grads(data, ps):
    jcfg, params = data["jcfg"], data["params"]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b, d: jmgn.loss_fn(q, jcfg, b, denom=d)))
    denom = jnp.asarray(ps.denom)
    total, grads = 0.0, None
    for p in range(ps.stacked["senders"].shape[0]):
        b = {k: jnp.asarray(v[p]) for k, v in ps.stacked.items()}
        loss, g = grad_fn(params, b, denom)
        total = total + loss
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
    return float(total), _np(grads)


def _port_loss_and_grads(model, ps):
    stacked, denom = _torch_batch(ps)
    batches = ({k: v[p] for k, v in stacked.items()}
               for p in range(stacked["senders"].shape[0]))
    loss = aggregate_gradients(lambda m, b: mgn.loss_fn(m, b, denom), model,
                               batches)
    return float(loss), params_to_jax(model, grads=True)


def test_partition_loss_and_grads_match_jax(data):
    """The loss and gradients summed over one sample's partitions equal
    jax.value_and_grad(loss_fn) summed over the same partitions."""
    ps = data["pps"][0]
    want_loss, want = _jax_loss_and_grads(data, data["jps"][0])
    got_loss, got = _port_loss_and_grads(_model(data), ps)
    np.testing.assert_allclose(got_loss, want_loss, rtol=GRAD_TOL)
    _close(got, want, atol=GRAD_TOL, rtol=GRAD_TOL, what="grads")
    # every part of the network learns, the edge path included
    for name in ("edge_encoder", "proc_edge", "node_encoder", "decoder"):
        assert any(np.abs(x).max() > 0
                   for x in jax.tree_util.tree_leaves(got[name])), name


def test_remat_on_equals_off_and_counts_the_recompute(data, monkeypatch):
    """Remat recomputes each layer in the backward pass: the same loss, the
    same gradients to REMAT_TOL, and twice the segment-sum forwards
    (2 x L x P) against L x P backwards. The backward of the two edge
    gathers is a segment-sum too: 2 x L x P more calls of the plain
    segment-sum, with remat on or off."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = seg_ref.segment_sum_csr, seg_ref.segment_sum_csr_backward

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(seg_ref, "segment_sum_csr", count("fwd", fwd))
    monkeypatch.setattr(seg_ref, "segment_sum_csr_backward",
                        count("bwd", bwd))
    ps = data["pps"][1]
    n_parts, n_layers = ps.stacked["senders"].shape[0], SIZE["n_mp_layers"]
    out = {}
    for remat in (True, False):
        calls.update(fwd=0, bwd=0)
        out[remat] = _port_loss_and_grads(_model(data, remat=remat), ps)
        assert calls["fwd"] == ((2 if remat else 1) + 2) * n_layers * n_parts
        assert calls["bwd"] == n_layers * n_parts
    assert out[True][0] == out[False][0]
    _close(out[True][1], out[False][1], atol=REMAT_TOL, rtol=REMAT_TOL)


def test_adam_update_matches_jax():
    """One Adam step (clip, cosine schedule, bias correction) on random
    leaves, with a norm above the clip threshold: f32 on both sides."""
    rng = np.random.default_rng(0)
    shapes = [(7, 3), (3,), (4, 5, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) * 20 for s in shapes]
    cfg = dict(total_steps=10, warmup_steps=2)
    jst = jadam.adam_init(params)
    pst = padam.adam_init([torch.from_numpy(p) for p in params])
    jp, pp = params, [torch.from_numpy(p) for p in params]
    for _ in range(3):
        jp, jst, jm = jadam.adam_update(jadam.AdamConfig(**cfg), grads, jst,
                                        jp)
        pp, pst, pm = padam.adam_update(
            padam.AdamConfig(**cfg), [torch.from_numpy(g) for g in grads],
            pst, pp)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _close([p.numpy() for p in pp], _np(jp), atol=1e-6)
    _close([m.numpy() for m in pst.mu], _np(jst.mu), atol=1e-6)
    _close([v.numpy() for v in pst.nu], _np(jst.nu), atol=1e-6)
    assert int(pst.step) == int(jst.step) == 3


def test_convert_roundtrip_and_adam_state(data):
    """params_to_jax inverts params_from_jax; a JAX AdamState loads in the
    order of model.leaves(), which is JAX's leaf order."""
    model = _model(data)
    tree = params_to_jax(model)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(data["params"])
    _close(tree, data["params"], atol=0.0)
    st = jadam.adam_init(data["params"])
    st = st._replace(step=jnp.asarray(4, jnp.int32),
                     mu=jax.tree_util.tree_map(lambda x: x + 1.0, st.mu))
    pst = adam_state_from_jax(_np(st), model)
    assert int(pst.step) == 4
    names = [n for n, _ in model.leaves()]
    assert len(pst.mu) == len(names)
    assert all(bool((m == 1.0).all()) for m in pst.mu)
    # leaves() lists a stacked JAX leaf as its layers in order, in the
    # pytree's sorted-key order
    assert names[0].startswith("decoder.")
    i = names.index("proc_edge.0.layers.0.b")
    assert names[i + 1] == "proc_edge.1.layers.0.b"


def test_nonfinite_step_is_skipped_bit_for_bit(data):
    """A NaN in the node features: the step reports skipped, and the
    parameters and Adam state are exactly what they were."""
    cfg = data["cfg"]
    model = _model(data)
    step = ptrain.make_gnn_step_fn(cfg, padam.AdamConfig(total_steps=4))
    opt = padam.adam_init([p for _, p in model.leaves()])
    opt, *_ = step(model, opt, *_torch_batch(data["pps"][0]))
    before = [p.detach().clone() for p in model.parameters()]
    stacked, denom = _torch_batch(data["pps"][1])
    stacked["node_feats"] = stacked["node_feats"].clone()
    stacked["node_feats"][0, 3, 1] = float("nan")
    new_opt, loss, _, skipped = step(model, opt, stacked, denom)
    assert skipped and not np.isfinite(float(loss))
    for a, b in zip(before, model.parameters()):
        assert torch.equal(a, b)
    assert new_opt is opt and int(opt.step) == 1
    # and a finite step after it goes on from the same state
    opt, loss, _, skipped = step(model, opt, *_torch_batch(data["pps"][1]))
    assert not skipped and int(opt.step) == 2


@pytest.mark.parametrize("value", [np.inf, np.nan])
def test_nonfinite_on_a_masked_edge_gets_the_same_verdict_as_jax(data,
                                                                  value):
    """A nonfinite value on a masked edge slot alone (its edge features):
    JAX's guard and the port's reach the same verdict from the same
    parameters and batch, and leave parameters and Adam state as they were.

    The port's gathers' backward leaves masked edges out of its CSRs, and so
    does its forward aggregation, so the value never reaches the port's
    loss (finite here, JAX's NaN); it still reaches the edge encoder's
    weight gradients (0 x inf at the masked row), so both guards skip."""
    jcfg, cfg, params = data["jcfg"], data["cfg"], data["params"]
    ps = data["pps"][0]
    p, e = np.argwhere(ps.stacked["edge_mask"] == 0)[0]
    stacked = {k: v.copy() for k, v in ps.stacked.items()}
    stacked["edge_feats"][p, e, 0] = value
    jstep = jtrain.make_gnn_step_fn(jcfg, jadam.AdamConfig(total_steps=4))
    jopt = jadam.adam_init(params)
    jparams, jopt2, jloss, _, jskipped = jstep(
        params, jopt, {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(ps.denom))
    model = _model(data)
    step = ptrain.make_gnn_step_fn(cfg, padam.AdamConfig(total_steps=4))
    opt = padam.adam_init([q for _, q in model.leaves()])
    new_opt, loss, _, skipped = step(
        model, opt, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.tensor(ps.denom, dtype=torch.float32))
    assert skipped and bool(jskipped)
    assert not np.isfinite(float(jloss)) and np.isfinite(float(loss))
    _close(params_to_jax(model), params, 0.0, what="port params")
    _close(_np(jparams), params, 0.0, what="JAX params")
    assert new_opt is opt and int(opt.step) == 0
    _close(_np(jopt2), _np(jopt), 0.0, what="JAX Adam state")


def test_predict_and_eval_match_jax(data):
    """predict_gnn and eval_gnn on train and test samples, same params."""
    jcfg, cfg = data["jcfg"], data["cfg"]
    jtr, jte, jni, jno = data["jd"]
    ptr, pte, pni, pno = data["pd"]
    want = jtrain.predict_gnn(jcfg, data["params"], jtr + jte, jni, jno)
    got = ptrain.predict_gnn(cfg, _model(data), ptr + pte, pni, pno)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=EVAL_TOL, rtol=EVAL_TOL)
    wm = jtrain.eval_gnn(jcfg, data["params"], jte, jni, jno)
    gm = ptrain.eval_gnn(cfg, _model(data), pte, pni, pno)
    assert sorted(gm) == sorted(wm)
    for k in ("pressure", "tau_x", "tau_y", "tau_z"):
        for m in ("rel_l2", "rel_l1"):
            np.testing.assert_allclose(gm[k][m], wm[k][m], atol=EVAL_TOL,
                                       rtol=EVAL_TOL)
