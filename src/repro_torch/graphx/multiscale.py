"""Multi-scale edge union over nested prefixes (paper SIII-C), on tensors.

Port of ``repro.graphx.multiscale``: every level is a fixed-shape hash-grid
kNN over the first ``n_l`` points, and a fine-level edge is masked when the
same (sender, receiver) pair exists at a coarser level ("keep the coarsest
occurrence"), with static shapes (sum over levels of 2 * n_l * k edge
slots). The valid points of a level are a prefix, its length given by one
count for all levels or one count per level.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.graphx import hashgrid
from repro_torch.telemetry import span


@dataclass(frozen=True)
class MultiscaleSpec:
    """Static signature of a multi-scale graph build."""
    level_sizes: Tuple[int, ...]          # increasing (coarse -> fine)
    k: int
    grids: Tuple[hashgrid.GridSpec, ...]  # one per level

    @property
    def n_points(self) -> int:
        return self.level_sizes[-1]

    @property
    def n_edges(self) -> int:
        return sum(2 * n * self.k for n in self.level_sizes)

    @property
    def level_of_edge(self) -> np.ndarray:
        """Static (n_edges,) level id of every edge slot."""
        return np.concatenate([np.full(2 * n * self.k, lvl, np.int32)
                               for lvl, n in enumerate(self.level_sizes)])


def auto_multiscale_spec(level_sizes: Sequence[int],
                         k: int = 6) -> MultiscaleSpec:
    sizes = tuple(level_sizes)
    if list(sizes) != sorted(sizes):
        raise ValueError("level_sizes must be increasing (coarse -> fine)")
    grids = tuple(hashgrid.auto_spec(n, k) for n in sizes)
    return MultiscaleSpec(level_sizes=sizes, k=k, grids=grids)


def multiscale_edges(points, n_valid, ms: MultiscaleSpec):
    """Union of per-level symmetric kNN edges with cross-level dedup masks.

    points: (n_finest, 3); n_valid: a host integer, the count of valid
    points, a prefix (nested sampling orders them that way), or a sequence
    of host integers, one valid count per level (sharded serving: each
    shard's slice of level ``l`` is its own prefix of length
    ``n_valid[l]``, which the total does not determine). Returns (senders
    (E,) i32, receivers (E,) i32, edge_mask (E,) bool) with E = ms.n_edges;
    masked slots have senders = receivers = 0.
    """
    if points.shape[0] != ms.n_points:
        raise ValueError(f"points has {points.shape[0]} rows, spec expects "
                         f"{ms.n_points}")
    if np.ndim(n_valid) == 0:
        counts = [min(int(n_valid), n_l) for n_l in ms.level_sizes]
    elif np.ndim(n_valid) == 1:
        counts = [int(c) for c in n_valid]
        if len(counts) != len(ms.level_sizes):
            raise ValueError(f"per-level n_valid has {len(counts)} entries "
                             f"for {len(ms.level_sizes)} levels")
    else:
        raise ValueError(f"n_valid must be a scalar or (n_levels,) "
                         f"sequence, got shape {np.shape(n_valid)}")
    nbrs = []
    for lvl, (n_l, nv, gspec) in enumerate(zip(ms.level_sizes, counts,
                                               ms.grids)):
        with span("knn", level=lvl):
            idx, _, mask = hashgrid.knn(points[:n_l], nv, gspec)
        nbrs.append((idx, mask))

    seg_s, seg_r, seg_m = [], [], []
    for lvl, (idx, mask) in enumerate(nbrs):
        s, r, em = hashgrid.symmetric_edges(idx, mask)
        for c_lvl in range(lvl):
            c_idx, c_mask = nbrs[c_lvl]
            n_c = ms.level_sizes[c_lvl]
            both = (s < n_c) & (r < n_c) & em
            sc = torch.clamp(s, 0, n_c - 1).long()
            rc = torch.clamp(r, 0, n_c - 1).long()
            # coarse edge set = symmetric closure of coarse neighbor lists:
            # (s, r) present iff s in nbr[r] or r in nbr[s]
            in_r = torch.any((c_idx[rc] == s[:, None]) & c_mask[rc], dim=1)
            in_s = torch.any((c_idx[sc] == r[:, None]) & c_mask[sc], dim=1)
            em = em & ~(both & (in_r | in_s))
        seg_s.append(s)
        seg_r.append(r)
        seg_m.append(em)

    senders = torch.cat(seg_s)
    receivers = torch.cat(seg_r)
    emask = torch.cat(seg_m)
    senders = torch.where(emask, senders, 0)
    receivers = torch.where(emask, receivers, 0)
    return senders, receivers, emask
