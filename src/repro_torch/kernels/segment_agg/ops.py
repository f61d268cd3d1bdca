"""Segment-sum: the CUDA kernels for tensors on the card, their plain versions
for tensors on the CPU (dispatch by device; there is no other switch).

``prepare`` builds a CSR once per graph, outside the message-passing loop;
``segment_sum_prepared`` runs once per layer. It is differentiable on both
devices through :class:`SegmentSum`, whose backward
(``segment_sum_backward``, the transpose: a row gather) is a kernel too.
:func:`gather_rows` is the other way round: a row gather whose backward is
the segment-sum kernel over a CSR of the gather's index.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.segment_agg import ref
from repro_torch.kernels.segment_agg.ref import SegmentCSR, prepare

__all__ = ["SegmentCSR", "SegmentSum", "GatherRows", "prepare",
           "segment_sum_prepared", "segment_sum_backward", "gather_rows",
           "gather_rows_backward"]

_THREADS = 256      # threads per block: blockDim.x over columns x nodes
_TAIL_BLOCKS = 1024  # backward: blocks that zero the masked rows, grid-stride


def _lib():
    fn = _build.load("segment_sum").segment_sum_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
    return fn


def _lib_backward():
    fn = _build.load("segment_sum").segment_sum_backward_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
    return fn


class SegmentSum(torch.autograd.Function):
    """``out[n] = sum of messages[perm[j]]`` over ``n``'s CSR run, with the
    transpose as its backward: ``grad_msg[perm[j]] = grad_out[n]`` inside
    the runs, zero for the masked edges outside them. Only ``perm`` and
    ``row_ptr`` are saved, never the (E, D) messages."""

    @staticmethod
    def forward(ctx, messages, perm, row_ptr):
        ctx.save_for_backward(perm, row_ptr)
        ctx.n_edges = messages.shape[0]
        if _build.plain(messages):
            return ref.segment_sum_csr(messages, perm, row_ptr)
        return _launch(SegmentCSR(perm, row_ptr), messages,
                       segment_sum_prepared)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        perm, row_ptr = ctx.saved_tensors
        return segment_sum_backward(SegmentCSR(perm, row_ptr), grad_out,
                                    ctx.n_edges), None, None


def segment_sum_prepared(prep: SegmentCSR, messages):
    """messages (E, D) f32 -> (N, D) f32 over a prepared CSR."""
    return SegmentSum.apply(messages, prep.perm, prep.row_ptr)


segment_sum_prepared.launches = 0


def segment_sum_backward(prep: SegmentCSR, grad_out, n_edges: int):
    """grad_out (N, D) f32 -> grad_msg (n_edges, D) f32: the transpose of
    :func:`segment_sum_prepared` over the same CSR."""
    if _build.plain(grad_out):
        return ref.segment_sum_csr_backward(grad_out, prep.perm,
                                            prep.row_ptr, n_edges)
    return _launch_backward(prep, grad_out, n_edges)


segment_sum_backward.launches = 0


class GatherRows(torch.autograd.Function):
    """``h[idx]`` (a plain ``index_select``), with the transpose as its
    backward: ``grad_h[n] = sum of grad[perm[j]]`` over ``n``'s run of the
    CSR of ``idx`` (``prepare(idx, N, mask)``), summed in run order by the
    segment-sum kernel on the card and its plain version on the CPU. Only
    ``perm`` and ``row_ptr`` are saved, never a row of ``h``.

    Precondition: a CSR built with an edge mask leaves the masked edges out,
    so their rows of ``grad`` are dropped. That is exact only when those
    rows are exactly zero, as in MeshGraphNet's message-passing layer: its
    edge output is multiplied by the edge mask, and LayerNorm, Linear and
    SiLU map a zero upstream gradient row to an exactly-zero row while the
    activations are finite. With no mask every edge is in the CSR."""

    @staticmethod
    def forward(ctx, h, idx, perm, row_ptr):
        ctx.save_for_backward(perm, row_ptr)
        return h.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        perm, row_ptr = ctx.saved_tensors
        return gather_rows_backward(SegmentCSR(perm, row_ptr), grad), \
            None, None, None


def gather_rows(h, idx, prep: SegmentCSR):
    """h (N, D), idx (E,) int -> h[idx] (E, D), differentiable through
    :class:`GatherRows` over ``prep``, the CSR of ``idx`` over N nodes.
    ``gather_rows.launches`` counts its backward's kernel launches."""
    if prep.n_segments != h.shape[0] or prep.perm.numel() != idx.numel():
        raise ValueError(f"gather_rows: a CSR of {prep.perm.numel()} edges "
                         f"over {prep.n_segments} nodes for h of "
                         f"{h.shape[0]} rows and {idx.numel()} indices")
    return GatherRows.apply(h, idx, prep.perm, prep.row_ptr)


gather_rows.launches = 0


def gather_rows_backward(prep: SegmentCSR, grad):
    """grad (E, D) f32, the gradient of ``h[idx]`` -> grad_h (N, D) f32:
    the segment-sum of ``grad`` over ``prep``, the CSR of ``idx``. ``grad``
    may be a column slice of a wider tensor (the gradient of
    ``torch.cat``); the kernel reads it in place."""
    if _build.plain(grad):
        return ref.segment_sum_csr(grad, prep.perm, prep.row_ptr)
    return _launch(prep, grad, gather_rows)


def _check_csr(prep: SegmentCSR, dev, n_edges: int):
    for name, t, length in (("perm", prep.perm, n_edges),
                            ("row_ptr", prep.row_ptr, None)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() \
                or (length is not None and t.numel() != length):
            raise ValueError(f"segment_sum: {name} must be a contiguous "
                             f"int32 vector on {dev}"
                             + (f" of length {length}" if length else ""))


def _threads(d: int):
    cols = d // 4
    tx = min(1 << (cols - 1).bit_length(), 128)
    return tx, max(_THREADS // tx, 1)


def _float4_rows(x):
    """``x`` if the kernels can read it in place (rows of float4s a stride
    apart, 16-byte aligned: the gradient of ``torch.cat`` is a column slice
    and qualifies), else one contiguous copy of it."""
    if x.stride(1) == 1 and x.stride(0) % 4 == 0 \
            and x.stride(0) >= x.shape[1] and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch(prep: SegmentCSR, messages, counter):
    """The segment-sum kernel over ``prep``; one launch is added to
    ``counter.launches``."""
    dev = messages.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu tensors, not {dev}")
    if messages.dtype != torch.float32 or messages.dim() != 2:
        raise ValueError("segment_sum: messages must be a 2-D float32 "
                         f"tensor, got {messages.dtype} "
                         f"{tuple(messages.shape)}")
    e, d = messages.shape
    if d % 4:
        # the kernel reads float4 rows; every width on the path is a
        # multiple of 4
        raise ValueError(f"segment_sum: D={d} must be a multiple of 4")
    _check_csr(prep, dev, e)
    n = prep.n_segments
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    messages = _float4_rows(messages)
    tx, ty = _threads(d)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(messages.data_ptr(), prep.perm.data_ptr(),
                        prep.row_ptr.data_ptr(), out.data_ptr(), n, d,
                        messages.stride(0), tx, ty, stream), "segment_sum")
    counter.launches += 1
    return out


def _launch_backward(prep: SegmentCSR, grad_out, n_edges: int):
    dev = grad_out.device
    if dev.type != "cuda":
        raise ValueError("segment_sum_backward runs on cuda or cpu tensors, "
                         f"not {dev}")
    n = prep.n_segments
    if grad_out.dtype != torch.float32 or grad_out.dim() != 2 \
            or grad_out.shape[0] != n:
        raise ValueError("segment_sum_backward: grad_out must be a 2-D "
                         f"float32 tensor of {n} rows, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)}")
    d = grad_out.shape[1]
    if d % 4:
        raise ValueError(f"segment_sum_backward: D={d} must be a multiple "
                         "of 4")
    grad_out = _float4_rows(grad_out)
    _check_csr(prep, dev, n_edges)
    grad_msg = torch.empty((n_edges, d), dtype=torch.float32, device=dev)
    if n_edges == 0 or d == 0:
        return grad_msg
    tx, ty = _threads(d)
    fn = _lib_backward()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(grad_out.data_ptr(), prep.perm.data_ptr(),
                        prep.row_ptr.data_ptr(), grad_msg.data_ptr(), n,
                        n_edges, d, grad_out.stride(0), tx, ty,
                        min(_TAIL_BLOCKS, -(-n_edges // ty)), stream),
                     "segment_sum_backward")
    segment_sum_backward.launches += 1
    return grad_msg
