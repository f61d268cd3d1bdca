"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

A kernel has no CPU mode, so the ``cuda`` tests skip without a card. The
wrapper tests run anywhere: a tensor that is neither on the CPU nor on the
card is refused, never routed to the plain version."""
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
    rng = np.random.default_rng(seed)
    if kind == "random":
        pts = rng.normal(size=(n, 3)).astype(np.float32)
    elif kind == "ties":
        pts = rng.normal(size=(5, 3)).astype(np.float32)[rng.integers(0, 5, n)]
    else:   # lattice: exact ties in d2 at every shell
        pts = rng.integers(-2, 3, size=(n, 3)).astype(np.float32)
    ci = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cv = rng.random((n, c)) < 0.5
    cv[:3] = False
    cv[3:6, 2:] = False
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pts, pts[ci], ci, cv)]


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
@pytest.mark.parametrize("kind,seed", [("random", 0), ("ties", 1),
                                       ("lattice", 2)])
def test_knn_kernel_matches_plain(cuda, kind, seed):
    """Bit-equal: same distance arithmetic, same (d2, slot) order."""
    k = knn_ops.KERNEL_K
    args = [t.to(cuda) for t in _knn_case(kind, seed)]
    before = knn_ops.topk_neighbors.launches
    ki, kd, km = knn_ops.topk_neighbors(*args, k)
    assert knn_ops.topk_neighbors.launches == before + 1
    pi, pd, pm = knn_ref.topk_neighbors(*args, k)
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    torch.testing.assert_close(kd, pd, atol=0.0, rtol=0.0)


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


def _fa_case(seed: int, b: int, s: int, h: int, kvh: int, hd: int = 256):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(np.float32))
            for n in (h, kvh, kvh)]


# (dtype, B, S, H, KV, causal, window, softcap). The kernel stages 64-key
# tiles and skips 32-key chunks: S = 640 with window 100 skips whole tiles
# before the window, S = 200 and 300 end in a ragged tile.
FA_CASES = [
    ("bfloat16", 2, 300, 4, 2, True, None, 50.0),
    ("float32", 2, 300, 4, 2, True, None, 50.0),
    ("bfloat16", 1, 640, 2, 1, True, 100, 50.0),
    ("float32", 1, 640, 2, 1, True, 100, 50.0),
    ("float32", 2, 200, 4, 2, True, 48, None),
    ("float32", 1, 130, 2, 2, False, 64, None),
]
# f32: the same function, sums in another order; bf16: one output rounding
FA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case):
    dtype, b, s, h, kvh, causal, window, cap = case
    q, k, v = (t.to(cuda, getattr(torch, dtype))
               for t in _fa_case(s + h, b, s, h, kvh))
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, 256) for t in (q, k, v))
    want = fa_ref.attention(qf, kf, vf, group_size=h // kvh, causal=causal,
                            window=window, softcap=cap)
    want = want.reshape(b, h, s, 256).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_TOL[dtype],
                               rtol=FA_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_is_not_built_for(cuda):
    """The kernel is built for hd = 256 in bf16 and f32 only."""
    q, k, v = (t.to(cuda) for t in _fa_case(0, 1, 64, 2, 1, hd=128))
    with pytest.raises(ValueError, match="hd=256"):
        fa_ops.mha(q, k, v)
    q, k, v = (t.to(cuda, torch.float16) for t in _fa_case(0, 1, 64, 2, 1))
    with pytest.raises(ValueError, match="bfloat16 and float32"):
        fa_ops.mha(q, k, v)


def test_wrappers_refuse_other_devices():
    q, cp, ci, cv = (t.to("meta") for t in _knn_case("random", 0, n=8, c=8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        knn_ops.topk_neighbors(q, cp, ci, cv, 6)
    msg, recv, _ = _seg_case(0, 8, 20, 4)
    prep = seg_ops.prepare(recv, 8)
    prep = seg_ops.SegmentCSR(prep.perm.to("meta"), prep.row_ptr.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg_ops.segment_sum_prepared(prep, msg.to("meta"))
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


def test_library_name_tracks_the_source():
    """A library is named by a hash of its source and flags, so an edited
    source never loads a stale build."""
    for name, src in _build.SOURCES.items():
        assert src.is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
