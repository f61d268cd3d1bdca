"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

A kernel has no CPU mode, so the ``cuda`` tests skip without a card. The
wrapper tests run anywhere: a tensor that is neither on the CPU nor on the
card is refused, never routed to the plain version."""
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn import ref as knn_ref
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.kernels.segment_agg import ref as seg_ref


def _knn_case(kind: str, seed: int, n: int = 300, c: int = 256):
    """Rows of five kinds, by row index mod 5: scattered valid slots; a valid
    prefix with one hole (as a hash-grid row, less the query itself); no
    valid slot; fewer than k valid; every slot valid."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        pts = rng.normal(size=(n, 3)).astype(np.float32)
    elif kind == "ties":
        pts = rng.normal(size=(5, 3)).astype(np.float32)[rng.integers(0, 5, n)]
    else:   # lattice: exact ties in d2 at every shell
        pts = rng.integers(-2, 3, size=(n, 3)).astype(np.float32)
    ci = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cv = rng.random((n, c)) < 0.5
    slots = np.arange(c)[None, :]
    prefix = (slots < rng.integers(0, c + 1, n)[:, None]) & \
        (slots != rng.integers(0, c, n)[:, None])
    kind_of_row = np.arange(n) % 5
    cv = np.where((kind_of_row == 1)[:, None], prefix, cv)
    cv[kind_of_row == 2] = False
    cv[kind_of_row == 3] &= slots < 4
    cv[kind_of_row == 4] = True
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pts, pts[ci], ci, cv)]


def _knn_matches_plain(args):
    k = knn_ops.KERNEL_K
    before = knn_ops.topk_neighbors.launches
    ki, kd, km = knn_ops.topk_neighbors(*args, k)
    torch.cuda.synchronize()
    assert knn_ops.topk_neighbors.launches == before + 1
    pi, pd, pm = knn_ref.topk_neighbors(*args, k)
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    torch.testing.assert_close(kd, pd, atol=0.0, rtol=0.0)


def _seg_case(seed: int, n: int, e: int, d: int):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n, e)
    mask = rng.random(e) > 0.5
    recv = torch.from_numpy(np.where(mask, recv, 0).astype(np.int32))
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    mask = torch.from_numpy(mask)
    return msg * mask[:, None], recv, mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 300, 4097])
@pytest.mark.parametrize("c", [16, 37, 128, 256, 384])
@pytest.mark.parametrize("kind,seed", [("random", 0), ("ties", 1),
                                       ("lattice", 2)])
def test_knn_kernel_matches_plain(cuda, kind, seed, c, n):
    """Bit-equal: same distance arithmetic, same (d2, slot) order. C = 37
    takes the scalar loads, C = 384 more than one group of chunks, C = 16 a
    part of one chunk."""
    _knn_matches_plain([t.to(cuda) for t in _knn_case(kind, seed, n, c)])


@pytest.mark.cuda
def test_knn_kernel_reads_a_misaligned_row_with_scalar_loads(cuda):
    """Positions that start 4 bytes past a 16-byte boundary (a contiguous
    view into a larger buffer) go through the scalar loads, bit-equal."""
    q, cp, ci, cv = (t.to(cuda) for t in _knn_case("random", 3, 300, 256))
    buf = torch.empty(cp.numel() + 1, device=cuda)
    shifted = buf[1:].view(cp.shape)
    shifted.copy_(cp)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    _knn_matches_plain([q, shifted, ci, cv])


@pytest.mark.cuda
def test_knn_kernel_matches_plain_on_hash_grid_candidates(cuda):
    """The candidate lists of a 4,096-point car cloud, as the serving path
    builds them: valid slots a prefix with the query's own slot a hole."""
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import hashgrid
    verts, faces = geo.car_surface(geo.sample_params(0))
    pts_np, _ = sample_surface(verts, faces, 4096, np.random.default_rng(0))
    spec = hashgrid.calibrate_spec(pts_np, knn_ops.KERNEL_K)
    pts = torch.from_numpy(pts_np).to(cuda)
    cand, valid, _ = hashgrid.csr_candidate_lists(pts, 4096, spec)
    assert cand.shape[1] % 128 == 0 and bool((~valid[:, -1]).any())
    _knn_matches_plain([pts, pts[cand.long()], cand, valid])


@pytest.mark.cuda
def test_dense_layout_knn_on_the_card_matches_the_cpu(cuda):
    """``hashgrid.knn`` with the dense layout (``build_table``'s rows as the
    candidates) on a 2,048-point car cloud padded to 2,112: the card (kNN
    kernel launched once) and the CPU (plain version) give equal indices,
    masks and distances."""
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import hashgrid
    verts, faces = geo.car_surface(geo.sample_params(1))
    pts_np, _ = sample_surface(verts, faces, 2048, np.random.default_rng(1))
    buf = np.zeros((2112, 3), np.float32)
    buf[:2048] = pts_np
    spec = hashgrid.calibrate_spec(pts_np, knn_ops.KERNEL_K, n_points=2112,
                                   layout="dense")
    before = knn_ops.topk_neighbors.launches
    got = hashgrid.knn(torch.from_numpy(buf).to(cuda), 2048, spec)
    torch.cuda.synchronize()
    assert knn_ops.topk_neighbors.launches == before + 1
    want = hashgrid.knn(torch.from_numpy(buf), 2048, spec)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d", [(64, 800, 512), (97, 300, 12),
                                   (1000, 20, 64)])
def test_segment_sum_kernel_matches_plain(cuda, n, e, d):
    """Exact: the kernel sums each run in edge order, as the plain version
    does (narrow rows, and mostly empty segments)."""
    msg, recv, mask = (t.to(cuda) for t in _seg_case(n + e + d, n, e, d))
    prep = seg_ops.prepare(recv, n, mask)
    before = seg_ops.segment_sum_prepared.launches
    got = seg_ops.segment_sum_prepared(prep, msg)
    assert seg_ops.segment_sum_prepared.launches == before + 1
    want = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


@pytest.mark.cuda
def test_kernels_refuse_shapes_they_are_not_built_for(cuda):
    """kNN is built for k = 6 only and segment-sum reads float4 rows: any
    other k, or a width that is not a multiple of 4, raises on the card."""
    args = [t.to(cuda) for t in _knn_case("random", 0, n=8, c=16)]
    with pytest.raises(ValueError, match="built for k=6"):
        knn_ops.topk_neighbors(*args, 5)
    msg, recv, mask = (t.to(cuda) for t in _seg_case(0, 8, 20, 13))
    with pytest.raises(ValueError, match="multiple of 4"):
        seg_ops.segment_sum_prepared(seg_ops.prepare(recv, 8, mask), msg)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 7, 300, 4097])
@pytest.mark.parametrize("d", [4, 64, 512])
def test_segment_sum_backward_kernel_matches_plain(cuda, d, n, masked):
    """Bit-equal: the backward kernel copies grad_out rows (no rounding);
    masked edges, outside every run, get zero rows, and so do the edges of
    an all-masked graph's tail."""
    e = 3 * n + 5
    msg, recv, mask = (t.to(cuda) for t in _seg_case(n * d, n, e, d))
    if not masked:
        mask = torch.ones_like(mask)
    prep = seg_ops.prepare(recv, n, mask)
    g_out = torch.randn((n, d), generator=torch.Generator().manual_seed(n),
                        dtype=torch.float32).to(cuda)
    before = seg_ops.segment_sum_backward.launches
    got = seg_ops.segment_sum_backward(prep, g_out, e)
    torch.cuda.synchronize()
    assert seg_ops.segment_sum_backward.launches == before + 1
    want = seg_ref.segment_sum_csr_backward(g_out, prep.perm, prep.row_ptr, e)
    assert torch.equal(got, want)
    assert not got[~mask].any()


@pytest.mark.cuda
def test_segment_sum_backward_kernel_reads_a_column_slice(cuda):
    """grad_out as autograd hands it over from torch.cat([h, agg]): the
    right half of a wider tensor, rows a stride apart, read in place."""
    n, e, d = 300, 2000, 64
    msg, recv, mask = (t.to(cuda) for t in _seg_case(1, n, e, d))
    prep = seg_ops.prepare(recv, n, mask)
    wide = torch.randn((n, 2 * d), generator=torch.Generator().manual_seed(1))
    g_out = wide.to(cuda)[:, d:]
    assert not g_out.is_contiguous() and g_out.stride(0) == 2 * d
    got = seg_ops.segment_sum_backward(prep, g_out, e)
    want = seg_ref.segment_sum_csr_backward(g_out.contiguous(), prep.perm,
                                            prep.row_ptr, e)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d,stride", [(300, 2000, 64, 64),
                                          (300, 2000, 64, 192),
                                          (97, 700, 12, 36),
                                          (64, 800, 512, 1536)])
def test_segment_sum_kernel_reads_strided_rows(cuda, n, e, d, stride):
    """Bit-equal at stride == cols (the aggregation) and stride > cols (a
    column slice of a wider tensor, as the gathers' gradient), read in
    place: the wrapper launches on the slice itself."""
    msg, recv, mask = (t.to(cuda) for t in _seg_case(n + d, n, e, d))
    wide = torch.randn((e, stride), generator=torch.Generator().manual_seed(
        stride)).to(cuda)
    wide[:, stride - d:] = msg
    view = wide[:, stride - d:]
    assert view.stride() == (stride, 1)
    prep = seg_ops.prepare(recv, n, mask)
    before = seg_ops.segment_sum_prepared.launches
    got = seg_ops.segment_sum_prepared(prep, view)
    assert seg_ops.segment_sum_prepared.launches == before + 1
    want = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    assert torch.equal(got, want)
    assert seg_ops._float4_rows(view) is view


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_gather_rows_gradient_on_the_card_matches_the_cpu(cuda, masked):
    """h[send] and h[recv] through gather_rows into torch.cat, as in the
    message-passing layer: the gradient of h on the card equals the CPU's
    bit for bit (both sum each CSR run in edge order), with one kernel
    launch per gather, each on its column slice of the cat's gradient."""
    n, e, d = 300, 2000, 64
    _, recv, mask = _seg_case(4, n, e, d)
    rng = np.random.default_rng(5)
    send = torch.from_numpy(np.where(mask.numpy(), rng.integers(0, n, e),
                                     0).astype(np.int32))
    if not masked:
        mask = None
    h0 = torch.randn((n, d), generator=torch.Generator().manual_seed(6))
    e_feat = torch.randn((e, d), generator=torch.Generator().manual_seed(7))
    g = torch.randn((e, 3 * d), generator=torch.Generator().manual_seed(8))
    if masked:
        g = g * mask[:, None]
    grads = {}
    for dev in ("cpu", cuda):
        s, r = send.to(dev), recv.to(dev)
        m = None if mask is None else mask.to(dev)
        h = h0.detach().to(dev).requires_grad_()
        before = seg_ops.gather_rows.launches
        msg = torch.cat([
            seg_ops.gather_rows(h, s.long(), seg_ops.prepare(s, n, m)),
            seg_ops.gather_rows(h, r.long(), seg_ops.prepare(r, n, m)),
            e_feat.to(dev)], -1)
        msg.backward(g.to(dev))
        assert seg_ops.gather_rows.launches == before + (
            2 if dev == cuda else 0)
        grads[str(dev)] = h.grad.cpu()
    assert torch.equal(grads["cuda"], grads["cpu"])
    assert grads["cuda"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["misaligned", "transposed",
                                    "odd_stride"])
def test_gather_rows_backward_copies_what_it_cannot_read(cuda, layout):
    """A gradient the kernel cannot read as float4 rows (misaligned,
    stride(1) != 1, a row stride not a multiple of 4) is copied once and
    still goes through the kernel, bit-equal; never the plain version."""
    n, e, d = 97, 700, 16
    msg, recv, mask = (t.to(cuda) for t in _seg_case(9, n, e, d))
    if layout == "misaligned":
        buf = torch.empty(e * d + 1, device=cuda)
        grad = buf[1:].view(e, d)
        grad.copy_(msg)
        assert grad.data_ptr() % 16
    elif layout == "transposed":
        grad = msg.t().contiguous().t()
        assert grad.stride(1) != 1
    else:
        grad = torch.zeros((e, d + 2), device=cuda)[:, :d]
        grad.copy_(msg)
        assert grad.stride(0) % 4
    prep = seg_ops.prepare(recv, n, mask)
    before = seg_ops.gather_rows.launches
    got = seg_ops.gather_rows_backward(prep, grad)
    assert seg_ops.gather_rows.launches == before + 1
    want = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_segment_sum_gradient_on_the_card_matches_the_cpu(cuda):
    """Autograd through SegmentSum on the card: the messages' gradient and,
    through a small MeshGraphNet, every parameter's gradient equal the
    CPU's; the edge path's are nonzero. A card path that detached the
    aggregation would leave the edge encoder and edge MLPs at zero."""
    import copy

    from repro_torch.configs.base import GNNConfig
    from repro_torch.models import meshgraphnet as mgn

    msg, recv, mask = _seg_case(2, 97, 600, 16)
    prep = seg_ops.prepare(recv, 97, mask)
    grads = {}
    for dev in ("cpu", cuda):
        p = seg_ops.SegmentCSR(prep.perm.to(dev), prep.row_ptr.to(dev))
        x = msg.to(dev).detach().requires_grad_()
        (seg_ops.segment_sum_prepared(p, x) ** 2).sum().backward()
        grads[str(dev)] = x.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], atol=1e-5,
                               rtol=1e-5)
    assert grads["cuda"].any()

    cfg = GNNConfig().reduced().replace(hidden=16, n_mp_layers=2)
    rng = np.random.default_rng(3)
    n, e = 120, 900
    s, r = (torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
            for _ in range(2))
    em = torch.from_numpy((rng.random(e) > 0.2).astype(np.float32))
    nf, ef, tg = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for shape in ((n, cfg.node_in), (e, cfg.edge_in),
                                (n, cfg.node_out)))
    batch = dict(node_feats=nf, edge_feats=ef * em[:, None], senders=s,
                 receivers=r, targets=tg, loss_mask=torch.ones(n),
                 edge_mask=em)
    cpu = mgn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    before = (seg_ops.segment_sum_prepared.launches,
              seg_ops.segment_sum_backward.launches,
              seg_ops.gather_rows.launches)
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        mgn.loss_fn(model, {k: v.to(dev) for k, v in batch.items()}).backward()
    # remat: each layer's forward runs twice on the card, its backward once;
    # the two gathers' backward runs the segment-sum kernel, counted apart
    assert seg_ops.segment_sum_prepared.launches == before[0] + 4
    assert seg_ops.segment_sum_backward.launches == before[1] + 2
    assert seg_ops.gather_rows.launches == before[2] + 4
    for (name, pc), (_, pg) in zip(cpu.named_parameters(),
                                   card.named_parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-5,
                                   rtol=1e-4, msg=name)
    for name in ("edge_encoder", "proc_edge.0"):
        g = [p.grad for k, p in card.named_parameters() if k.startswith(name)]
        assert all(x is not None for x in g) and any(x.any() for x in g), name


def _fa_case(seed: int, b: int, s: int, h: int, kvh: int, hd: int = 256):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(np.float32))
            for n in (h, kvh, kvh)]


# (dtype, B, S, H, KV, causal, window, softcap[, hd]), hd 256 unless given.
# bf16 runs the wgmma kernel
# (128-row blocks, 64-key tiles), f32 the CUDA-core kernel (64-row blocks of
# 256 threads, 64-key tiles, register tiles of S and O). S = 640 with window
# 100 skips whole tiles before the window; S = 200, 300 and 1,000 end in a
# ragged tile, and S = 200 inside one 128-row block; window 300 at S = 1,000
# puts the window's edge inside a key tile; S = 4,608 with window 4,096 is
# the serve shape at B = 1. The f32 edges of its tiling: S = 1 and 17 (under
# one tile), 65 and 129 (one row past a 64- or 128-row block), window 1
# (each row sees only itself), window 40 (under a block's rows), non-causal
# with a window, group 8. At hd 128 (the instances for the llama-style and
# MoE decoders): GQA groups 2, 7 (yi, 56 / 8), 8 at qwen3-moe's prefill
# length and 12 (starcoder2, 48 / 4), ragged S, S = 1, window 1, a window
# with the softcap, non-causal with and without a window.
FA_CASES = [
    ("bfloat16", 2, 300, 4, 2, True, None, 50.0),
    ("float32", 2, 300, 4, 2, True, None, 50.0),
    ("bfloat16", 1, 640, 2, 1, True, 100, 50.0),
    ("float32", 1, 640, 2, 1, True, 100, 50.0),
    ("float32", 2, 200, 4, 2, True, 48, None),
    ("float32", 1, 130, 2, 2, False, 64, None),
    ("bfloat16", 1, 4608, 4, 2, True, 4096, 50.0),
    ("bfloat16", 2, 200, 4, 2, True, 48, 50.0),
    ("bfloat16", 1, 1000, 2, 1, True, 300, 50.0),
    ("bfloat16", 1, 130, 2, 2, False, 64, 50.0),
    ("bfloat16", 1, 256, 2, 2, True, None, 50.0),
    ("bfloat16", 2, 640, 4, 2, True, None, None),
    ("float32", 1, 1, 2, 1, True, None, 50.0),
    ("float32", 2, 17, 4, 2, True, None, 50.0),
    ("float32", 1, 65, 2, 1, True, None, 50.0),
    ("float32", 1, 129, 4, 2, True, 100, 50.0),
    ("float32", 1, 300, 2, 1, True, 1, 50.0),
    ("float32", 1, 300, 2, 1, True, 40, 50.0),
    ("float32", 1, 257, 2, 1, False, 40, 50.0),
    ("float32", 1, 300, 8, 1, True, None, 50.0),
    ("float32", 1, 4608, 2, 1, True, 4096, 50.0),
    ("bfloat16", 2, 300, 4, 2, True, None, None, 128),
    ("float32", 2, 300, 4, 2, True, None, None, 128),
    ("bfloat16", 1, 640, 7, 1, True, None, None, 128),
    ("float32", 1, 640, 7, 1, True, None, None, 128),
    ("bfloat16", 1, 200, 12, 1, True, None, None, 128),
    ("float32", 1, 200, 12, 1, True, None, None, 128),
    ("bfloat16", 1, 1000, 2, 1, True, 300, 50.0, 128),
    ("float32", 1, 1000, 2, 1, True, 300, 50.0, 128),
    ("float32", 1, 1, 2, 1, True, None, None, 128),
    ("float32", 2, 65, 4, 2, True, 1, None, 128),
    ("bfloat16", 1, 130, 2, 2, False, 64, None, 128),
    ("float32", 1, 129, 4, 2, False, None, None, 128),
    ("bfloat16", 1, 4608, 8, 1, True, None, None, 128),
    ("float32", 1, 4608, 8, 1, True, None, None, 128),
]
# Elementwise atol and rtol. f32: the same function, sums in another order.
# bf16: the tolerance of tests/test_kernels.py.
FA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Outputs are about sqrt(e / n) for n keys, 0.03 at S = 4,608, so 2e-2 would
# pass a kernel that drops a 64-key tile of a row. bf16 is also held per
# (row, head) to |got - want| / |want| over hd: the output rounding, and the
# wgmma kernel rounds P to bf16 before PV and takes tanh.approx and
# ex2.approx; measured on an H100 at the serve shape: see PERF.md. The plain
# version with one key tile per row dropped must fail it.
FA_BF16_ROW_RTOL = 1e-2
KEY_TILE = 64    # the wgmma kernel's K/V tile


def _row_rel_err(got, want):
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def _plain_dropping_a_tile(qf, kf, vf, gs, causal, window, cap):
    """A stand-in for a wrong kernel: the plain version with the first key
    tile of each row's range skipped wherever the row has keys in a later
    tile, as an off-by-one in the kernel's first tile would."""
    s, hd = qf.shape[1:]
    i = torch.arange(s, device=qf.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    tile = i // KEY_TILE
    first = tile[None, :] == (mask.int().argmax(1) // KEY_TILE)[:, None]
    mask &= ~(first & (mask & ~first).any(1, keepdim=True))
    kr, vr = (t.repeat_interleave(gs, 0).float() for t in (kf, vf))
    sc = torch.einsum("hqd,hkd->hqk", qf.float(), kr) / math.sqrt(hd)
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    sc = torch.where(mask, sc, -1e30)
    return torch.einsum("hqk,hkd->hqd", sc.softmax(-1), vr).to(qf.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case):
    dtype, b, s, h, kvh, causal, window, cap = case[:8]
    hd = case[8] if len(case) > 8 else 256
    q, k, v = (t.to(cuda, getattr(torch, dtype))
               for t in _fa_case(s + h + hd, b, s, h, kvh, hd=hd))
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, hd) for t in (q, k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=h // kvh, causal=causal,
                            window=window, softcap=cap)
    want = want.reshape(b, h, s, hd).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])
    if dtype == "bfloat16":
        assert float(_row_rel_err(got, want).max()) <= FA_BF16_ROW_RTOL
        wrong = _plain_dropping_a_tile(qf, kf, vf, h // kvh, causal, window,
                                       cap).reshape(b, h, s, hd)
        assert float(_row_rel_err(wrong.transpose(1, 2), want).max()) > \
            FA_BF16_ROW_RTOL


# Whisper's contract at hd 64, both dtypes: the bidirectional encoder
# (Skv = Sq = 1,500 = 23 x 64 + 28, a ragged last key tile that must be
# masked past Skv without causal masking or a window; and at 1,536 = 24 x
# 64, where no tile is masked), the cross-attention (Sq 224 against Skv
# 1,500, and 64 and 300 against 1,536 and 100), and the decoder's causal
# self-attention at 224. (dtype, B, Sq, Skv, H, KV, causal)
FA_SKV_CASES = [
    (dtype, *shape) for dtype in ("bfloat16", "float32") for shape in (
        (2, 1500, 1500, 4, 4, False),
        (1, 1536, 1536, 4, 2, False),
        (2, 224, 1500, 4, 4, False),
        (1, 64, 1536, 2, 2, False),
        (1, 300, 100, 4, 2, False),
        (2, 224, 224, 4, 4, True))]


def _plain_dropping_last_tile(qf, kf, vf, gs):
    """A stand-in for a wrong non-causal kernel: the plain version with the
    last key tile (the ragged one where Skv is not a multiple of 64)
    dropped."""
    skv, hd = kf.shape[1:]
    keep = torch.arange(skv, device=qf.device) < (skv - 1) // KEY_TILE * \
        KEY_TILE
    kr, vr = (t.repeat_interleave(gs, 0).float() for t in (kf, vf))
    sc = torch.einsum("hqd,hkd->hqk", qf.float(), kr) / math.sqrt(hd)
    sc = torch.where(keep, sc, -1e30)
    return torch.einsum("hqk,hkd->hqd", sc.softmax(-1), vr).to(qf.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_SKV_CASES)
def test_flash_attention_kernel_matches_plain_at_hd64(cuda, case):
    dtype, b, sq, skv, h, kvh, causal = case
    hd = 64
    rng = np.random.default_rng(sq + skv + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, heads, hd)).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
        for n, heads in ((sq, h), (skv, kvh), (skv, kvh)))
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    qf = q.transpose(1, 2).reshape(-1, sq, hd)
    kf, vf = (t.transpose(1, 2).reshape(-1, skv, hd) for t in (k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=h // kvh, causal=causal)
    want = want.reshape(b, h, sq, hd).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])
    if dtype == "bfloat16":
        assert float(_row_rel_err(got, want).max()) <= FA_BF16_ROW_RTOL
        wrong = (_plain_dropping_a_tile(qf, kf, vf, h // kvh, True, None,
                                        None) if causal else
                 _plain_dropping_last_tile(qf, kf, vf, h // kvh))
        wrong = wrong.reshape(b, h, sq, hd).transpose(1, 2)
        assert float(_row_rel_err(wrong, want).max()) > FA_BF16_ROW_RTOL


# Zamba2's shared attention at hd 80 (padded to 128 columns inside both
# kernels, TMA filling the wgmma kernel's pad columns with zeros), held to
# every case hd 64 and 128 are: causal at zamba2's head count (H = KV = 32)
# and at S = 4,096, ragged S, S = 1 and 65 (f32 tile edges), GQA group 4,
# a window with the softcap, non-causal with a ragged last key tile (1,500)
# and with Skv != Sq both ways. (dtype, B, Sq, Skv, H, KV, causal, window,
# softcap)
FA_HD80_CASES = [
    (dtype, *shape) for dtype in ("bfloat16", "float32") for shape in (
        (2, 300, 300, 32, 32, True, None, None),
        (1, 4096, 4096, 2, 2, True, None, None),
        (1, 1, 1, 2, 2, True, None, None),
        (1, 65, 65, 4, 1, True, None, None),
        (2, 300, 300, 8, 2, True, None, None),
        (1, 1000, 1000, 2, 1, True, 300, 50.0),
        (2, 1500, 1500, 4, 4, False, None, None),
        (2, 224, 1000, 4, 4, False, None, None),
        (1, 300, 100, 8, 2, False, None, None))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_HD80_CASES)
def test_flash_attention_kernel_matches_plain_at_hd80(cuda, case):
    dtype, b, sq, skv, h, kvh, causal, window, cap = case
    hd = 80
    rng = np.random.default_rng(sq + skv + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, heads, hd)).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
        for n, heads in ((sq, h), (skv, kvh), (skv, kvh)))
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    qf = q.transpose(1, 2).reshape(-1, sq, hd)
    kf, vf = (t.transpose(1, 2).reshape(-1, skv, hd) for t in (k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=h // kvh, causal=causal,
                            window=window, softcap=cap)
    want = want.reshape(b, h, sq, hd).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])
    if dtype == "bfloat16":
        assert float(_row_rel_err(got, want).max()) <= FA_BF16_ROW_RTOL
        if sq > KEY_TILE or not causal:
            wrong = (_plain_dropping_a_tile(qf, kf, vf, h // kvh, True,
                                            window, cap) if causal else
                     _plain_dropping_last_tile(qf, kf, vf, h // kvh))
            wrong = wrong.reshape(b, h, sq, hd).transpose(1, 2)
            assert float(_row_rel_err(wrong, want).max()) > FA_BF16_ROW_RTOL


# Every reduced config at hd 32 (f32 only, padded to 64 columns inside the
# f32 kernel): gemma2 reduced's serve shape (B 4, S 16, H 4, KV 2: one
# ragged key tile) with its window 16 and softcap 50 and without the window,
# the timing shape (S 4,096), S = 1 and 65, GQA group 4, ragged S with a
# window inside a tile, non-causal with a ragged tile and with Skv != Sq
# both ways (whisper reduced's cross-attention: 16 frames).
# (B, Sq, Skv, H, KV, causal, window, softcap)
FA_HD32_CASES = [
    (4, 16, 16, 4, 2, True, 16, 50.0),
    (4, 16, 16, 4, 2, True, None, 50.0),
    (2, 4096, 4096, 4, 2, True, None, 50.0),
    (1, 1, 1, 2, 2, True, None, None),
    (1, 65, 65, 4, 1, True, None, None),
    (2, 300, 300, 8, 2, True, 40, 50.0),
    (2, 1500, 1500, 4, 4, False, None, None),
    (2, 24, 16, 4, 4, False, None, None),
    (1, 300, 100, 8, 2, False, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_HD32_CASES)
def test_flash_attention_kernel_matches_plain_at_hd32(cuda, case):
    b, sq, skv, h, kvh, causal, window, cap = case
    hd = 32
    rng = np.random.default_rng(sq + skv + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, heads, hd)).astype(
        np.float32)).to(cuda) for n, heads in ((sq, h), (skv, kvh),
                                                (skv, kvh)))
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    qf = q.transpose(1, 2).reshape(-1, sq, hd)
    kf, vf = (t.transpose(1, 2).reshape(-1, skv, hd) for t in (k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=h // kvh, causal=causal,
                            window=window, softcap=cap)
    want = want.reshape(b, h, sq, hd).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=FA_TOL["float32"],
                               rtol=FA_TOL["float32"])


@pytest.mark.parametrize("s,window", [(640, None), (1000, 300)])
def test_bf16_row_check_passes_rounding_and_fails_a_dropped_tile(s, window):
    """The bf16 row check admits the plain version's own bf16 rounding and
    rejects the plain version with one key tile per row dropped."""
    q, k, v = _fa_case(s, 1, s, 2, 1)
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, 256) for t in (q, k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=2, window=window,
                            softcap=50.0)
    args = [t.to(torch.bfloat16) for t in (qf, kf, vf)]
    rounded = fa_ref.attention(*args, group_size=2, window=window,
                               softcap=50.0)
    assert float(_row_rel_err(rounded, want).max()) <= FA_BF16_ROW_RTOL
    wrong = _plain_dropping_a_tile(*args, 2, True, window, 50.0)
    assert float(_row_rel_err(wrong, rounded).max()) > FA_BF16_ROW_RTOL


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_is_not_built_for(cuda):
    """Both kernels are built for hd 64, 80, 128 and 256 in bf16 and f32
    only, the f32 kernel also for hd 32, and take causal masking only with
    Skv == Sq; the bf16 kernel's grid takes at most 65,535 blocks of 128
    rows, which its C entry checks before it reads any memory. Each C entry
    refuses any other hd (96 here; 32 in bf16, naming the f32 kernel), and
    causal masking with Skv != Sq, itself."""
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(cuda, dtype)
                   for t in _fa_case(0, 1, 64, 2, 1, hd=96))
        dims = "(32, 64, 80, 128, 256)" if dtype == torch.float32 else \
            "(64, 80, 128, 256)"
        with pytest.raises(ValueError,
                           match=re.escape(f"{dims}, got hd=96")):
            fa_ops.mha(q, k, v)
        qf = q.transpose(1, 2).reshape(2, 64, 96).contiguous()
        status = fa_ops._lib(dtype)(
            qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), 2, 1,
            64, 64, 1, 0, 96, 96 ** -0.5, 0.0, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(status, "flash_attention")
        q, k, v = (t.to(cuda, dtype)
                   for t in _fa_case(0, 1, 130, 2, 1, hd=64))
        with pytest.raises(ValueError, match="Skv == Sq"):
            fa_ops.mha(q, k[:, :128], v[:, :128])
        qf = q.transpose(1, 2).reshape(2, 130, 64).contiguous()
        status = fa_ops._lib(dtype)(
            qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), 2, 2,
            130, 128, 1, 0, 64, 1 / 8, 0.0, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(status, "flash_attention")
    q, k, v = (t.to(cuda, torch.bfloat16)
               for t in _fa_case(0, 1, 64, 2, 1, hd=32))
    with pytest.raises(ValueError, match=r"got hd=32 \(only the float32 "
                       r"kernel, flash_attention\.cu"):
        fa_ops.mha(q, k, v)
    qf = q.transpose(1, 2).reshape(2, 64, 32).contiguous()
    status = fa_ops._lib(torch.bfloat16)(
        qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), 2, 1,
        64, 64, 1, 0, 32, 32 ** -0.5, 0.0, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(status, "flash_attention")
    q, k, v = (t.to(cuda, torch.float16) for t in _fa_case(0, 1, 64, 2, 1))
    with pytest.raises(ValueError, match="bfloat16 and float32"):
        fa_ops.mha(q, k, v)
    q = torch.zeros((1, 128, 256), dtype=torch.bfloat16, device=cuda)
    status = fa_ops._lib(torch.bfloat16)(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(), 1, 1,
        65535 * 128 + 1, 65535 * 128 + 1, 1, 0, 256, 1 / 16, 0.0, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(status, "flash_attention")


def test_wrappers_refuse_other_devices():
    q, cp, ci, cv = (t.to("meta") for t in _knn_case("random", 0, n=8, c=8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        knn_ops.topk_neighbors(q, cp, ci, cv, 6)
    msg, recv, _ = _seg_case(0, 8, 20, 4)
    prep = seg_ops.prepare(recv, 8)
    prep = seg_ops.SegmentCSR(prep.perm.to("meta"), prep.row_ptr.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg_ops.segment_sum_prepared(prep, msg.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg_ops.segment_sum_backward(prep, torch.zeros((8, 4), device="meta"),
                                     20)
    q, k, v = (t.to("meta") for t in _fa_case(0, 1, 8, 2, 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_ops.mha(q, k, v)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.glob("kernels/*.so"))


@pytest.mark.parametrize("edit", [None, "flash_attention_wgmma", "flags"])
def test_library_name_tracks_the_source(monkeypatch, tmp_path, edit):
    """A library is named by a hash of its own source and the flags, so an
    edited source never loads a stale build: editing one source renames that
    kernel's library and no other's, editing the flags renames them all."""
    copies = {}
    for name, src in _build.SOURCES.items():
        assert src.is_file()
        copies[name] = tmp_path / src.name
        copies[name].write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "SOURCES", copies)
    before = {n: _build.library_path(n) for n in copies}
    assert len(set(before.values())) == len(before)
    for name, path in before.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    if edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    elif edit is not None:
        copies[edit].write_text(copies[edit].read_text() + "\n// edited\n")
    changed = [n for n in copies if _build.library_path(n) != before[n]]
    assert changed == ([] if edit is None else list(copies)
                       if edit == "flags" else [edit])


def test_flash_library_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: where the bf16 kernel cannot be built, asking for it
    raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    for dtype in fa_ops._ENTRY:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fa_ops._lib(dtype)


_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "fail" in args[-1]:
    print("error: no such kernel")
    sys.exit(2)
time.sleep(0.2 if "wgmma" in args[-1] else 0.0)
open(out, "wb").write(b"lib")
print("ptxas info    : Used 42 registers")
"""


@pytest.mark.parametrize("fail", [False, True])
def test_build_compiles_in_parallel_and_times_each_source(
        monkeypatch, tmp_path, fail):
    """Each source gets its own compiler process and its own time; a failed
    compile raises and leaves no library behind."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    sources = {}
    for name in ("fast", "flash_attention_wgmma", "fail" if fail else "ok"):
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "SOURCES", sources)
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed .*fail.cu"):
            _build.build()
        assert not list((tmp_path / "kernels").glob("libfail-*.so"))
        assert not list((tmp_path / "kernels").glob("*.tmp"))
        return
    done = _build.build()
    assert set(done) == set(sources)
    for name, c in done.items():
        assert "Used 42 registers" in c.log and c.seconds >= 0
        assert _build.library_path(name).read_bytes() == b"lib"
    assert done["flash_attention_wgmma"].seconds >= 0.2
    assert _build.build() == {}    # nothing left to compile
    assert os.path.exists(_build.library_path("fast").with_suffix(".log"))



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_refuses_to_run_under_autograd(cuda, dtype):
    """Neither kernel has a backward: on the card, a call whose q, k or v
    requires grad raises (naming the plain train-mode attention) and
    launches nothing, with grad enabled; under ``torch.no_grad()``, or with
    inputs that need no grad, it runs."""
    q, k, v = (t.to(cuda, dtype) for t in _fa_case(0, 1, 64, 2, 1, hd=64))
    for needs in ("q", "k", "v"):
        args = {"q": q, "k": k, "v": v}
        args[needs] = args[needs].detach().requires_grad_()
        before = fa_ops.mha.launches
        with pytest.raises(RuntimeError, match="mode='train'"):
            fa_ops.mha(args["q"], args["k"], args["v"])
        assert fa_ops.mha.launches == before
        with torch.no_grad():
            out = fa_ops.mha(args["q"], args["k"], args["v"])
        torch.cuda.synchronize()
        assert fa_ops.mha.launches == before + 1 and not out.requires_grad
    fa_ops.mha(q, k, v)
    torch.cuda.synchronize()
