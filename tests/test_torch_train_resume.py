"""Crash-resume in the port, across the two packages, and serving from a
checkpoint.

* In the port: train N steps == train k, stop, resume to N, bit for bit
  (the cases of ``tests/test_train_resume.py``).
* Across packages: a checkpoint written by the port that the JAX trainer
  continues, and one written by the JAX trainer that the port continues,
  each against both packages' straight 4-step runs from the same initial
  weights: losses to a relative 1e-5 and parameters to 1e-6
  (``tests/test_torch_train.py``'s limits; its near-zero-gradient split at
  2 lr is not needed here: every element agrees to 3e-8 at this size).
Serving from a checkpoint is in ``test_torch_serve_ckpt.py``, the training
CLI's checkpoints and resume in ``test_torch_train_cli.py`` (split from
this file so that ``--dist loadfile`` spreads them).

Size: ``tests/test_train_resume.py``'s (hidden 16, 2 layers, levels
(32, 64), 2 partitions; ``_torch_train_common.resume_cfg``). The CPU runs are bit-reproducible at this size; at
full width PyTorch's multithreaded CPU kernels are not (3.4e-5 after two
steps), which is why the card holds the full-width resume (``chip_smoke.py``
phase 11).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_train_common import resume_cfg as _cfg
from _torch_train_common import resume_jcfg as _jcfg
from repro.ckpt import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.models import meshgraphnet as jmgn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_from_jax, params_to_jax

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6


def _same(a, b) -> bool:
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return sorted(pa) == sorted(pb) and all(torch.equal(pa[k], pb[k])
                                            for k in pa)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- in the port

def test_periodic_checkpoint_carries_opt_state(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    # ckpt_every=2 with 3 steps: the periodic write at step 2 happens, then
    # the final write at step 3 overwrites it
    m, _, _ = ptrain.train_gnn(_cfg(), steps=3, n_samples=2, ckpt_path=p,
                               log_every=100, ckpt_every=2, device="cpu")
    tree = ckpt.restore(p)
    assert tree["step"] == 3
    assert tree["opt_total_steps"] == 3
    assert tree["opt"]["step"].dtype == torch.int32
    assert tree["opt"]["step"].shape == () and int(tree["opt"]["step"]) == 3
    for k in ("params", "norm_in", "norm_out"):
        assert k in tree
    # the params in the JAX layout; mu/nu mirror the params tree
    leaves = jax.tree_util.tree_leaves
    structure = jax.tree_util.tree_structure
    want = params_to_jax(m)
    assert structure(_np(tree["params"])) == structure(want)
    for a, b in zip(leaves(_np(tree["params"])), leaves(want)):
        np.testing.assert_array_equal(a, b)
    for k in ("mu", "nu"):
        assert structure(_np(tree["opt"][k])) == structure(want)


def test_resume_matches_uninterrupted_run(tmp_path):
    cfg = _cfg()
    full_ck = str(tmp_path / "full.msgpack")
    m_full, losses_full, _ = ptrain.train_gnn(
        cfg, steps=4, n_samples=2, ckpt_path=full_ck, log_every=100,
        device="cpu")
    # "crash" after 2 steps of a 4-step run: same schedule horizon
    part_ck = str(tmp_path / "part.msgpack")
    _, losses_head, _ = ptrain.train_gnn(cfg, steps=2, n_samples=2,
                                         ckpt_path=part_ck, log_every=100,
                                         opt_total_steps=4, device="cpu")
    m_res, losses_tail, _ = ptrain.train_gnn(cfg, steps=4, n_samples=2,
                                             log_every=100, resume=part_ck,
                                             device="cpu")
    assert _same(m_full, m_res)
    assert losses_head + losses_tail == losses_full
    assert ckpt.restore(full_ck)["opt_total_steps"] == 4


def test_resume_rejects_non_checkpoint(tmp_path):
    p = str(tmp_path / "bogus.msgpack")
    ckpt.save(p, {"not_params": 1})
    with pytest.raises(ckpt.CheckpointError, match="not a training"):
        ptrain.train_gnn(_cfg(), steps=2, n_samples=2, resume=p,
                         device="cpu")


def test_periodic_saves_survive_midrun_kill(tmp_path):
    """The checkpoint at step k (not just the final one) is a valid resume
    point."""
    cfg = _cfg()
    p = str(tmp_path / "per.msgpack")
    ptrain.train_gnn(cfg, steps=2, n_samples=2, ckpt_path=p, log_every=100,
                     opt_total_steps=3, ckpt_every=1, device="cpu")
    tree = ckpt.restore(p)
    assert tree["step"] == 2 and tree["opt_total_steps"] == 3
    m3, losses3, _ = ptrain.train_gnn(cfg, steps=3, n_samples=2,
                                      log_every=100, resume=p, device="cpu")
    ref, losses_ref, _ = ptrain.train_gnn(cfg, steps=3, n_samples=2,
                                          log_every=100, opt_total_steps=3,
                                          device="cpu")
    assert _same(m3, ref)
    assert losses3 == losses_ref[2:]


# ------------------------------------------------------ across the packages

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Straight 4-step runs of both trainers from the JAX init, and the two
    hybrids: 2 steps in one package, checkpoint, 2 in the other."""
    d = tmp_path_factory.mktemp("cross")
    jcfg, cfg = _jcfg(), _cfg()
    params = _np(jmgn.init(jax.random.PRNGKey(0), jcfg))
    mp = pytest.MonkeyPatch()
    mp.setattr(ptrain.meshgraphnet, "init",
               lambda gen, c, device=None: params_from_jax(params, c,
                                                           device))
    try:
        out = {}
        jp, jl, _ = jtrain.train_gnn(jcfg, 4, 2, log_every=100,
                                     shard_devices=1)
        out["jax"] = (_np(jp), jl)
        pm, pl, _ = ptrain.train_gnn(cfg, 4, 2, log_every=100, device="cpu")
        out["port"] = (params_to_jax(pm), pl)
        a = str(d / "port2.msgpack")
        _, head, _ = ptrain.train_gnn(cfg, 2, 2, a, log_every=100,
                                      opt_total_steps=4, device="cpu")
        ap, tail, _ = jtrain.train_gnn(jcfg, 4, 2, log_every=100, resume=a,
                                       shard_devices=1)
        out["port_then_jax"] = (_np(ap), head + tail)
        b = str(d / "jax2.msgpack")
        _, head, _ = jtrain.train_gnn(jcfg, 2, 2, b, log_every=100,
                                      opt_total_steps=4, shard_devices=1)
        bm, tail, _ = ptrain.train_gnn(cfg, 4, 2, log_every=100, resume=b,
                                       device="cpu")
        out["jax_then_port"] = (params_to_jax(bm), head + tail)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("hybrid", ["port_then_jax", "jax_then_port"])
@pytest.mark.parametrize("straight", ["jax", "port"])
def test_cross_package_resume_matches_straight_run(runs, hybrid, straight):
    got_p, got_l = runs[hybrid]
    want_p, want_l = runs[straight]
    assert len(got_l) == 4
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    leaves = jax.tree_util.tree_leaves
    assert jax.tree_util.tree_structure(got_p) == \
        jax.tree_util.tree_structure(want_p)
    for g, w in zip(leaves(got_p), leaves(want_p)):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0)


def test_port_checkpoint_reads_as_jax_training_tree(tmp_path):
    """The port's checkpoint holds exactly the keys, dtypes and shapes of
    the JAX trainer's, tree for tree (not file for file: key order may
    differ)."""
    jcfg, cfg = _jcfg(), _cfg()
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    ptrain.train_gnn(cfg, 1, 2, a, log_every=100, device="cpu")
    jtrain.train_gnn(jcfg, 1, 2, b, log_every=100, shard_devices=1)
    ta, tb = _np(jckpt.restore(a)), _np(jckpt.restore(b))
    sa, sb = (jax.tree_util.tree_structure(t) for t in (ta, tb))
    assert sa == sb
    for x, y in zip(jax.tree_util.tree_leaves(ta),
                    jax.tree_util.tree_leaves(tb)):
        assert type(x) is type(y)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
    for k in ("step", "opt_total_steps"):
        assert ta[k] == tb[k] == 1
    for k in ("norm_in", "norm_out"):
        for s in ("mean", "std"):
            np.testing.assert_array_equal(ta[k][s], tb[k][s])
