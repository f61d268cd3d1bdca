"""Plain PyTorch versions of the segment-sum kernels, forward and backward
(the CPU path and the references the CUDA kernels are held against), and the
CSR preparation both paths share.

A fake tensor (``FakeTensorMode``) has shapes but no values, so no degrees
to loop over. Inside the dry run (``kernels._build.dry_run``, set by
``launch.dryrun``) each function takes a shape-only form for one: results
of the right shapes and dtypes, made by ops that read and write as many
bytes as the real ones (an ``index_add_`` of the messages into the (N, D)
result, a row gather for its transpose, zero run lengths), whose values
are not a segment sum. Outside the dry run a fake tensor raises."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build


def _shape_only(t) -> bool:
    """Whether ``t`` takes the shape-only form: a fake tensor, inside the
    dry run; a fake tensor elsewhere raises rather than get a result that
    is not a segment sum."""
    if not is_fake(t):
        return False
    if not _build.in_dry_run():
        raise RuntimeError(
            "segment_agg: a fake tensor outside kernels._build.dry_run() has "
            "no values to take segment sums of")
    return True


class SegmentCSR(NamedTuple):
    """Receiver-sorted CSR view of an edge list, built once per graph."""
    perm: torch.Tensor       # (E,) i32 edge ids, stably sorted by segment;
                             # masked edges sort last, outside every run
    row_ptr: torch.Tensor    # (N + 1,) i32 run boundaries into perm

    @property
    def n_segments(self) -> int:
        return self.row_ptr.numel() - 1


def prepare(segment_ids, num_segments: int,
            mask: Optional[torch.Tensor] = None) -> SegmentCSR:
    """Stable argsort by segment id + bincount/cumsum row pointers.

    Edges where ``mask`` is False go to a sentinel segment ``num_segments``
    that no run covers, so they are never read: padding edge slots (all of
    receiver 0 in the fixed-shape edge union) would otherwise make node 0 one
    long serial run. Their messages are zero, so leaving them out changes
    nothing.
    """
    seg = segment_ids.long()
    if mask is not None:
        seg = torch.where(mask.bool(), seg, num_segments)
    order = torch.argsort(seg, stable=True)
    if _shape_only(seg):
        counts = seg.new_zeros(num_segments)
    else:
        counts = torch.bincount(seg, minlength=num_segments + 1)[
            :num_segments]
    row_ptr = torch.zeros(num_segments + 1, dtype=torch.int32,
                          device=seg.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return SegmentCSR(order.to(torch.int32), row_ptr)


def segment_sum_csr(messages, perm, row_ptr):
    """out[n] = sum of messages[perm[j]] over j in [row_ptr[n], row_ptr[n+1]).

    Repeats the kernel's arithmetic: each run summed in f32 in edge order,
    starting from zero, one slot of every run per step.
    """
    n = row_ptr.numel() - 1
    out = messages.new_zeros((n, messages.shape[1]))
    if _shape_only(messages):
        return out.index_add_(0, perm.long(), messages)
    start = row_ptr[:-1].long()
    deg = row_ptr[1:].long() - start
    max_deg = int(deg.max()) if n else 0
    for s in range(max_deg):
        nodes = torch.nonzero(deg > s).squeeze(1)
        out[nodes] = out[nodes] + messages[perm[start[nodes] + s].long()]
    return out


def segment_sum_csr_backward(grad_out, perm, row_ptr, n_edges: int):
    """The transpose of :func:`segment_sum_csr`: grad_msg (n_edges, D) with
    row perm[j] = grad_out[n] for j in [row_ptr[n], row_ptr[n+1]), and zero
    for the edges outside every run (the masked ones). A copy, so the
    kernel's result equals it bit for bit."""
    n = row_ptr.numel() - 1
    if _shape_only(grad_out):
        return grad_out.index_select(0, perm.long())
    out = grad_out.new_zeros((n_edges, grad_out.shape[1]))
    deg = row_ptr[1:].long() - row_ptr[:-1].long()
    seg = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    out[perm[:seg.numel()].long()] = grad_out[seg]
    return out


def segment_sum(messages, segment_ids, num_segments: int):
    """messages (E, D); segment_ids (E,) in [0, num_segments).
    Returns (num_segments, D)."""
    return segment_sum_csr(messages, *prepare(segment_ids, num_segments))
