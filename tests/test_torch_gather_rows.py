"""``gather_rows`` on the CPU: the row gather ``h[idx]`` whose backward is the
segment-sum over a CSR of ``idx`` (a sender CSR for ``h[senders]``, the
receiver CSR for ``h[receivers]``), against autograd of the plain gather and,
through a small MeshGraphNet, against the JAX package's ``jax.grad``.

Tolerances: the forward is the same copy, held bit for bit; the gradient of
the gather alone to 1e-6 (the CSR sums each node's run in edge order,
autograd of the plain gather in its own order); the model's parameter
gradients to 1e-5 against JAX, as ``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.kernels.segment_agg import ops
from repro_torch.models import meshgraphnet as mgn
from repro_torch.models.convert import params_from_jax, params_to_jax

GATHER_TOL = 1e-6
GRAD_TOL = 1e-5
MODEL = dict(hidden=16, n_mp_layers=2)


def _case(seed: int, masked: bool, n: int = 97, e: int = 700, d: int = 12):
    """h (N, D), idx (E,) int64, mask (E,) bool or None, and an upstream
    gradient (E, D) that is exactly zero at masked edges (the precondition).
    Masked slots carry index 0, as the fixed-shape edge union's padding."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, e)
    mask = rng.random(e) > 0.3 if masked else None
    if masked:
        idx = np.where(mask, idx, 0)
    g = rng.normal(size=(e, d)).astype(np.float32)
    if masked:
        g = g * mask[:, None]
    h = rng.normal(size=(n, d)).astype(np.float32)
    return (torch.from_numpy(h), torch.from_numpy(idx),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(g))


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_is_the_plain_gather_bit_for_bit(masked, grad):
    h, idx, mask, _ = _case(0, masked)
    prep = ops.prepare(idx, h.shape[0], mask)
    with torch.set_grad_enabled(grad):
        got = ops.gather_rows(h.requires_grad_(grad), idx, prep)
    assert torch.equal(got, h[idx])
    assert got.requires_grad == grad


@pytest.mark.parametrize("masked", [False, True])
def test_gradient_equals_autograd_of_the_plain_gather(masked):
    h, idx, mask, g = _case(1, masked)
    prep = ops.prepare(idx, h.shape[0], mask)
    x = h.clone().requires_grad_()
    ops.gather_rows(x, idx, prep).backward(g)
    y = h.clone().requires_grad_()
    y[idx].backward(g)
    torch.testing.assert_close(x.grad, y.grad, atol=GATHER_TOL,
                               rtol=GATHER_TOL)
    assert x.grad.any()


def test_without_a_mask_every_edge_is_summed():
    """No mask: the CSR covers every edge, so every row of a long run (the
    padding slots' index 0) reaches node 0, summed in edge order: bit-equal
    to adding them one by one in f32."""
    h, idx, _, g = _case(2, False)
    idx[::3] = 0
    prep = ops.prepare(idx, h.shape[0])
    assert int(prep.row_ptr[-1]) == idx.numel()
    x = h.clone().requires_grad_()
    ops.gather_rows(x, idx, prep).backward(g)
    acc = torch.zeros(g.shape[1])
    for row in g[idx == 0]:
        acc = acc + row
    assert torch.equal(x.grad[0], acc)


def _record_backward(monkeypatch):
    """Record the gradient tensor each GatherRows.backward is handed."""
    seen = []
    inner = ops.gather_rows_backward

    def spy(prep, grad):
        seen.append(grad)
        return inner(prep, grad)
    monkeypatch.setattr(ops, "gather_rows_backward", spy)
    return seen


def test_reads_the_column_slice_of_the_cat_gradient(monkeypatch):
    """Autograd hands GatherRows.backward its columns of the gradient of
    torch.cat in place, rows 3 D floats apart, and the kernel's wrapper
    takes them as they are (no copy); anything it cannot read as float4
    rows is copied once."""
    seen = _record_backward(monkeypatch)
    h, s, _, _ = _case(3, False, d=16)
    r = torch.flip(s, (0,))
    e_feat = torch.randn((s.numel(), 16), generator=torch.Generator()
                         .manual_seed(3))
    n = h.shape[0]
    x = h.clone().requires_grad_()
    msg = torch.cat([ops.gather_rows(x, s, ops.prepare(s, n)),
                     ops.gather_rows(x, r, ops.prepare(r, n)), e_feat], -1)
    w = torch.randn((48, 5), generator=torch.Generator().manual_seed(4))
    (msg @ w).square().sum().backward()
    assert len(seen) == 2
    base = min(t.data_ptr() for t in seen)
    assert sorted(t.data_ptr() - base for t in seen) == [0, 16 * 4]
    for t in seen:
        assert not t.is_contiguous()
        assert t.shape == (s.numel(), 16) and t.stride() == (48, 1)
        assert ops._float4_rows(t) is t
    # what the kernel cannot read in place is copied, never refused
    wide = torch.zeros((8, 50))
    for odd in (wide[:, 2:18],             # rows 50 floats apart
                wide[:, 1:17],             # also misaligned
                torch.zeros((16, 8)).t(),  # stride(1) != 1
                torch.zeros(8 * 16 + 1)[1:].view(8, 16)):  # misaligned
        got = ops._float4_rows(odd)
        assert got is not odd and got.is_contiguous()
        assert torch.equal(got, odd)


def test_the_model_hands_every_gather_a_column_slice(monkeypatch):
    """In MeshGraphNet with remat, every gather's backward gets a column
    slice of the (E, 3 hidden) gradient of the edge MLP's input."""
    seen = _record_backward(monkeypatch)
    cfg = GNNConfig().reduced().replace(**MODEL, remat=True)
    batch = _batch(cfg, 5, masked=True)
    model = mgn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    mgn.loss_fn(model, _torch(batch)).backward()
    assert len(seen) == 2 * cfg.n_mp_layers
    for t in seen:
        assert t.stride() == (3 * cfg.hidden, 1)


def test_saves_only_the_csr_never_a_row_of_h():
    h, idx, mask, _ = _case(6, True)
    prep = ops.prepare(idx, h.shape[0], mask)
    packed = []

    def pack(t):
        packed.append(t)
        return t
    x = h.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ops.gather_rows(x, idx, prep)
    assert len(packed) == 2
    assert packed[0] is prep.perm and packed[1] is prep.row_ptr
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 and all(t.dtype == torch.int32 for t in saved)


def test_cpu_path_launches_no_kernel():
    h, idx, mask, g = _case(7, True)
    prep = ops.prepare(idx, h.shape[0], mask)
    before = (ops.gather_rows.launches, ops.segment_sum_prepared.launches)
    x = h.clone().requires_grad_()
    ops.gather_rows(x, idx, prep).backward(g)
    assert (ops.gather_rows.launches,
            ops.segment_sum_prepared.launches) == before


def test_a_csr_of_another_graph_is_refused():
    h, idx, _, _ = _case(8, False)
    with pytest.raises(ValueError, match="gather_rows"):
        ops.gather_rows(h, idx, ops.prepare(idx, h.shape[0] + 1))
    with pytest.raises(ValueError, match="gather_rows"):
        ops.gather_rows(h, idx[1:], ops.prepare(idx, h.shape[0]))


def _batch(cfg, seed: int, masked: bool, n: int = 80, e: int = 600):
    """A random graph (numpy), padding slots on node 0 when masked."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    m = rng.random(e) > 0.25 if masked else np.ones(e, bool)
    b = dict(
        node_feats=rng.normal(size=(n, cfg.node_in)).astype(np.float32),
        edge_feats=(rng.normal(size=(e, cfg.edge_in)) * m[:, None]
                    ).astype(np.float32),
        senders=np.where(m, s, 0).astype(np.int32),
        receivers=np.where(m, r, 0).astype(np.int32),
        targets=rng.normal(size=(n, cfg.node_out)).astype(np.float32),
        loss_mask=(rng.random(n) > 0.2).astype(np.float32))
    if masked:
        b["edge_mask"] = m.astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_masked_edges_get_exactly_zero_gather_gradients(monkeypatch, remat):
    """The precondition, held on the plain model: with the gathers as plain
    indexing (autograd's own backward), the gradient rows of both gathers at
    masked edges are exactly zero in every layer, so a CSR that leaves
    those edges out loses nothing."""
    cfg = GNNConfig().reduced().replace(**MODEL, remat=remat)
    batch = _batch(cfg, 9, masked=True)
    rows = []

    def plain(h, idx, prep):
        out = h[idx]
        if out.requires_grad:
            out.register_hook(rows.append)
        return out
    monkeypatch.setattr(mgn.segops, "gather_rows", plain)
    model = mgn.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    mgn.loss_fn(model, _torch(batch)).backward()
    masked = torch.from_numpy(batch["edge_mask"] == 0)
    assert masked.any() and len(rows) == 2 * cfg.n_mp_layers
    for g in rows:
        assert torch.isfinite(g).all()
        assert not g[masked].any()
        assert g[~masked].any()


def test_csrs_are_built_once_per_graph_outside_remat(monkeypatch):
    """Two CSRs (senders, receivers) per forward, however many layers, and
    none rebuilt when remat recomputes the layers in the backward pass."""
    calls = []
    inner = mgn.segops.prepare

    def count(*a, **k):
        calls.append(a[1])
        return inner(*a, **k)
    monkeypatch.setattr(mgn.segops, "prepare", count)
    cfg = GNNConfig().reduced().replace(**MODEL, remat=True)
    model = mgn.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    loss = mgn.loss_fn(model, _torch(_batch(cfg, 10, masked=True)))
    assert len(calls) == 2
    loss.backward()
    assert len(calls) == 2


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_model_gradients_match_jax(masked, remat):
    """Every parameter gradient of a 2-layer, hidden-16 MeshGraphNet equals
    jax.grad of the JAX package's loss_fn, from the same params and
    numpy-seeded batch, masked and unmasked."""
    jcfg = JaxGNNConfig().reduced().replace(**MODEL)
    cfg = GNNConfig().reduced().replace(**MODEL, remat=remat)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmgn.init(jax.random.PRNGKey(3), jcfg))
    batch = _batch(cfg, 11, masked=masked)
    loss_j, want = jax.value_and_grad(
        lambda p: jmgn.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))(params)
    model = params_from_jax(params, cfg, device="cpu")
    loss = mgn.loss_fn(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GRAD_TOL)
    got = params_to_jax(model, grads=True)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, want))):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    # every part of the network learns, the edge path through the gathers
    for name in ("edge_encoder", "proc_edge", "node_encoder", "decoder"):
        assert any(np.abs(x).max() > 0
                   for x in jax.tree_util.tree_leaves(got[name])), name
