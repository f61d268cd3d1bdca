"""Plain PyTorch version of the kNN top-k kernel (the CPU path and the
reference the CUDA kernel is held against)."""
from __future__ import annotations

import torch

# Large-but-finite sentinel for invalid candidates; "not found" is
# d2 >= BIG / 2, as in the JAX package.
BIG = 1e30


def topk_neighbors(q_pos, cand_pos, cand_idx, cand_valid, k: int):
    """Select the k nearest valid candidates of each query.

    q_pos (N, 3) f32; cand_pos (N, C, 3) f32; cand_idx (N, C) i32 with safe
    values in invalid slots; cand_valid (N, C) bool. Returns (idx (N, k) i32
    with -1 for missing, d2 (N, k) f32 with BIG for missing, mask (N, k)).

    Ties go to the lower candidate slot: a stable sort, never ``torch.topk``
    (which promises no order among equal values).
    """
    diff = cand_pos - q_pos[:, None, :]
    dx, dy, dz = diff.unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(cand_valid, d2, BIG)
    d2s, pick = torch.sort(d2, dim=1, stable=True)
    d2k = d2s[:, :k]
    idx = torch.gather(cand_idx, 1, pick[:, :k])
    mask = d2k < BIG * 0.5
    idx = torch.where(mask, idx, -1).to(torch.int32)
    return idx, d2k, mask
