"""kNN top-k: the CUDA kernel for tensors on the card, its plain version for
tensors on the CPU (dispatch by device; there is no other switch)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.knn import ref

KERNEL_K = 6        # knn_topk.cu instantiates GNNConfig.k_neighbors only


def _lib():
    fn = _build.load("knn_topk").knn_topk_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
    return fn


def topk_neighbors(q_pos, cand_pos, cand_idx, cand_valid, k: int):
    """q_pos (N, 3) f32; cand_pos (N, C, 3) f32; cand_idx (N, C) i32;
    cand_valid (N, C) bool. Returns (idx (N, k) i32 with -1 missing,
    d2 (N, k) f32, mask (N, k) bool)."""
    if _build.plain(q_pos):
        return ref.topk_neighbors(q_pos, cand_pos, cand_idx, cand_valid, k)
    return _launch(q_pos, cand_pos, cand_idx, cand_valid, k)


topk_neighbors.launches = 0


def _launch(q_pos, cand_pos, cand_idx, cand_valid, k: int):
    dev = q_pos.device
    if dev.type != "cuda":
        raise ValueError(f"knn_topk runs on cuda or cpu tensors, not {dev}")
    n, c = cand_idx.shape
    for name, t, dtype, shape in (
            ("q_pos", q_pos, torch.float32, (n, 3)),
            ("cand_pos", cand_pos, torch.float32, (n, c, 3)),
            ("cand_idx", cand_idx, torch.int32, (n, c)),
            ("cand_valid", cand_valid, torch.bool, (n, c))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"knn_topk: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if k != KERNEL_K or k > c:
        raise ValueError(f"knn_topk: the kernel is built for k={KERNEL_K} "
                         f"<= C, got k={k}, C={c}")
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n:
        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _build.check(fn(q_pos.data_ptr(), cand_pos.data_ptr(),
                            cand_idx.data_ptr(), cand_valid.data_ptr(),
                            idx.data_ptr(), d2.data_ptr(), n, c, stream),
                         "knn_topk")
        topk_neighbors.launches += 1
    return idx, d2, idx >= 0
