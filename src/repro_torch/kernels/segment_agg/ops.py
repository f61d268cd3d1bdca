"""Segment-sum: the CUDA kernel for tensors on the card, its plain version
for tensors on the CPU (dispatch by device; there is no other switch).

``prepare`` builds the receiver-sorted CSR once per graph, outside the
message-passing loop; ``segment_sum_prepared`` runs once per layer.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_agg import ref
from repro_torch.kernels.segment_agg.ref import SegmentCSR, prepare

__all__ = ["SegmentCSR", "prepare", "segment_sum_prepared"]

_THREADS = 256      # threads per block: blockDim.x over columns x nodes


def _lib():
    fn = _build.load("segment_sum").segment_sum_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    return fn


def segment_sum_prepared(prep: SegmentCSR, messages):
    """messages (E, D) f32 -> (N, D) f32 over a prepared CSR."""
    if messages.device.type == "cpu":
        return ref.segment_sum_csr(messages, prep.perm, prep.row_ptr)
    return _launch(prep, messages)


segment_sum_prepared.launches = 0


def _launch(prep: SegmentCSR, messages):
    dev = messages.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu tensors, not {dev}")
    if messages.dtype != torch.float32 or messages.dim() != 2 \
            or not messages.is_contiguous():
        raise ValueError("segment_sum: messages must be a contiguous 2-D "
                         f"float32 tensor, got {messages.dtype} "
                         f"{tuple(messages.shape)} "
                         f"(contiguous={messages.is_contiguous()})")
    e, d = messages.shape
    if d % 4 or messages.data_ptr() % 16:
        # the kernel reads float4 rows; every width on the path is a
        # multiple of 4 and fresh allocations are 16-byte aligned
        raise ValueError(f"segment_sum: D={d} must be a multiple of 4 and "
                         "messages 16-byte aligned")
    for name, t, length in (("perm", prep.perm, e),
                            ("row_ptr", prep.row_ptr, None)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() \
                or (length is not None and t.numel() != length):
            raise ValueError(f"segment_sum: {name} must be a contiguous "
                             f"int32 vector on {dev}"
                             + (f" of length {length}" if length else ""))
    n = prep.n_segments
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    cols = d // 4
    tx = min(1 << (cols - 1).bit_length(), 128)
    ty = max(_THREADS // tx, 1)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(messages.data_ptr(), prep.perm.data_ptr(),
                        prep.row_ptr.data_ptr(), out.data_ptr(), n, d, tx,
                        ty, stream), "segment_sum")
    segment_sum_prepared.launches += 1
    return out
