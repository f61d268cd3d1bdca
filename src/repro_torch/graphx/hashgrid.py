"""Hash-grid (cell-list) k-nearest-neighbor search on tensors.

Port of ``repro.graphx.hashgrid``, both layouts. ``layout='csr'`` (the
default): points are stably sorted by cell id, and each query's candidate
row is assembled from the 9 contiguous cell-id ranges of its 3x3x3 window
by 18 binary searches; nothing is held over the grid. ``layout='dense'``:
:func:`build_table` writes every cell's neighbourhood row of point ids
(O(n_cells * neigh_cap) memory, so ``calibrate_spec`` bounds its cell count
at ``cell_budget * n_points``), and a query reads its own cell's row. Both
give the same neighbour sets, and either way ``kernels.knn`` then keeps the
k nearest candidates (one call, whatever the layout).

Shapes are static per ``GridSpec``, as in the JAX package. The search is
exact whenever every point's k-th neighbor lies within one cell width on
every axis and no neighborhood overflows ``neigh_cap``; ``calibrate_spec``
picks such a spec from a reference cloud at setup time (host cKDTree, never
per request) and ``overflow_count`` checks a cloud against it.

Index tensors are int32 where the JAX package has int32 (cell ids, candidate
ids, neighbor ids), which is what the kernels take; they are widened to
int64 only where PyTorch indexes with them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.knn import ops as knn_ops

# CSR cell ids must stay addressable in int32; nothing is materialized over
# the grid, so this is the only resolution bound.
_MAX_INT32_CELLS = 2 ** 31 - 64

_OFFSETS = np.array([(dx, dy, dz)
                     for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], np.int32)        # (27, 3)

_XY_OFFSETS = np.array([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       np.int32)                               # (9, 2)


@dataclass(frozen=True)
class GridSpec:
    """Static shape signature of one hash-grid kNN search."""
    n_points: int                     # padded point-buffer length
    k: int                            # neighbors per query
    resolution: Tuple[int, int, int]  # cells per axis (rx, ry, rz)
    neigh_cap: int                    # candidate capacity per query (C)
    layout: str = "csr"               # 'csr' (occupied-cell) | 'dense' table

    @property
    def n_cells(self) -> int:
        rx, ry, rz = self.resolution
        return rx * ry * rz

    @property
    def n_candidates(self) -> int:
        return self.neigh_cap


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def auto_spec(n_points: int, k: int = 6, mode: str = "surface",
              resolution: int | Tuple[int, int, int] | None = None,
              neigh_cap: int | None = None, layout: str = "csr") -> GridSpec:
    """Heuristic spec for roughly isotropic uniform point clouds.

    ``mode='surface'``: points on a 2-manifold, occupied cells scale like
    R^2, so R ~ sqrt(n/k)/2. ``mode='volume'``: R ~ (n/k)^(1/3).
    ``resolution`` and ``neigh_cap`` override the heuristic. For real
    geometries prefer ``calibrate_spec`` (measures the cloud).
    """
    if resolution is None:
        if mode == "surface":
            r = int(round(math.sqrt(n_points / max(k, 1)) / 2))
        else:
            r = int(round((n_points / max(k, 1)) ** (1.0 / 3.0)))
        resolution = max(2, min(r, 128))
    if isinstance(resolution, int):
        resolution = (resolution,) * 3
    if neigh_cap is None:
        rx, ry, rz = resolution
        if mode == "surface":
            est = n_points / max(rx * ry, 1)   # occupied cells ~ one face
        else:
            est = n_points / max(rx * ry * rz, 1)
        # a 3x3x3 neighborhood crosses the surface in ~9 occupied cells
        occ_cells = 9 if mode == "surface" else 27
        neigh_cap = _round_up(max(4 * k, int(math.ceil(3 * occ_cells * est))),
                              128)
        neigh_cap = min(neigh_cap, n_points)
    return GridSpec(n_points=n_points, k=k, resolution=tuple(resolution),
                    neigh_cap=neigh_cap, layout=layout)


# calibrate_spec's default margins, the JAX package's: the cell is 1.3x the
# largest k-th-neighbor distance, the capacity 1.5x the fullest neighborhood
CELL_SAFETY = 1.3
OCCUPANCY_SAFETY = 1.5


def calibrate_spec(points: np.ndarray, k: int, n_points: int | None = None,
                   cell_safety: float = CELL_SAFETY,
                   occupancy_safety: float = OCCUPANCY_SAFETY,
                   cell_budget: float = 8.0, layout: str = "csr") -> GridSpec:
    """Measure a reference cloud and return an exact-by-construction spec.

    Host-side, setup-time only (one cKDTree query): the cell is
    ``cell_safety`` times the largest k-th-neighbor distance, and the
    capacity ``occupancy_safety`` times the fullest 3x3x3 neighborhood.
    ``layout='dense'`` holds a row per cell, so its cell count is bounded
    by ``cell_budget * n``; ``'csr'`` holds nothing over the grid, so only
    the int32 cell-id range bounds it. Fewer, larger cells keep the search
    exact, at the price of a larger ``neigh_cap``.
    """
    from scipy.spatial import cKDTree
    pts = np.asarray(points, np.float32)
    n = len(pts)
    dist, _ = cKDTree(pts).query(pts, k=min(k + 1, n))
    kth = float(dist[:, -1].max())
    extent = np.maximum(pts.max(0) - pts.min(0), 1e-6)
    cell = max(kth * cell_safety, 1e-6)
    res = tuple(int(max(1, math.floor(e / cell))) for e in extent)
    n_cells = res[0] * res[1] * res[2]
    max_cells = (max(int(cell_budget * n), 27) if layout == "dense"
                 else _MAX_INT32_CELLS)
    if n_cells > max_cells:
        shrink = (max_cells / n_cells) ** (1.0 / 3.0)
        res = tuple(int(max(1, math.floor(r * shrink))) for r in res)
    occ = int(neighborhood_counts(pts, res).max())
    cap = _round_up(max(int(math.ceil(occ * occupancy_safety)), 2 * k + 2),
                    128)
    return GridSpec(n_points=n_points or n, k=k, resolution=res,
                    neigh_cap=min(cap, n_points or n), layout=layout)


def _cells(points, valid, spec: GridSpec):
    """Per-point integer cell coords (N, 3) i32 + flat cell ids (N,) i32
    (``n_cells`` for padding). Keeps the JAX op order
    ``floor((pts - lo) / extent * res)`` in f32, so boundary points land in
    the same cells."""
    res = torch.tensor(spec.resolution, dtype=torch.int32,
                       device=points.device)
    big = 3.4e38
    pts = points.float()
    v = valid[:, None]
    lo = torch.where(v, pts, big).amin(0)
    hi = torch.where(v, pts, -big).amax(0)
    extent = torch.clamp(hi - lo, min=1e-6)
    scaled = torch.floor((pts - lo) / extent * res)
    # padding rows may hold anything: clamp before the int cast (the JAX
    # cast saturates, PyTorch's does not) so they cannot wrap
    scaled = torch.clamp(torch.nan_to_num(scaled, nan=0.0), -1.0,
                         float(max(spec.resolution)))
    cc = torch.minimum(torch.clamp(scaled.to(torch.int32), min=0), res - 1)
    cid = _flat_cid(cc, spec)
    cid = torch.where(valid, cid, spec.n_cells)
    return cc, cid


def _flat_cid(cc, spec: GridSpec):
    _, ry, rz = spec.resolution
    return (cc[..., 0] * ry + cc[..., 1]) * rz + cc[..., 2]


def csr_candidate_lists(points, n_valid, spec: GridSpec):
    """Occupied-cell CSR candidate gather: no per-cell table at all.

    The flat cell id is contiguous along z, so a query's 3x3x3 window is 9
    contiguous id ranges, each found by two binary searches into the stably
    sorted cell ids. The 9 segment lengths are prefix-summed into a packed
    row of width ``neigh_cap``; every slot maps back to its segment through
    one marker per segment start and a running sum. Slots past
    ``neigh_cap`` are dropped.

    Returns (cand (N, C) i32 safe-valued, cand_valid (N, C) bool,
    valid (N,) bool).
    """
    n = spec.n_points
    cap = spec.neigh_cap
    dev = points.device
    rz = spec.resolution[2]
    res = torch.tensor(spec.resolution, dtype=torch.int32, device=dev)
    valid = torch.arange(n, device=dev) < n_valid
    cc, cid = _cells(points, valid, spec)

    # stable: the candidate slot order, and so the kNN tie-breaks, follow it
    order = torch.argsort(cid, stable=True).to(torch.int32)
    sorted_cid = cid[order.long()].contiguous()

    xy = torch.from_numpy(_XY_OFFSETS).to(dev)
    col_cc = cc[:, None, :2] + xy[None]                        # (N, 9, 2)
    col_ok = torch.all((col_cc >= 0) & (col_cc < res[:2]), dim=-1)
    col_cc = torch.minimum(torch.clamp(col_cc, min=0), res[:2] - 1)
    col_base = (col_cc[..., 0] * res[1] + col_cc[..., 1]) * rz  # (N, 9)
    z_lo = torch.clamp(cc[:, 2] - 1, min=0)[:, None]
    z_hi = torch.clamp(cc[:, 2] + 1, max=rz - 1)[:, None]
    bounds = torch.stack([col_base + z_lo, col_base + z_hi + 1], dim=0)
    found = torch.searchsorted(sorted_cid, bounds.reshape(-1).contiguous(),
                               right=False).reshape(2, n, 9)
    start, end = found[0], found[1]                             # int64
    cnt = torch.where(col_ok, end - start, 0)
    base = torch.cumsum(cnt, dim=1) - cnt                       # (N, 9) excl.
    total = base[:, -1] + cnt[:, -1]                            # (N,)

    # segment of slot t = (number of j with base[j] <= t) - 1: one marker
    # per segment start, summed along the packed row (zero-length segments
    # stack their markers and are skipped)
    slots = torch.arange(cap, device=dev)
    marks = torch.zeros((n, cap + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, torch.clamp(base, 0, cap), torch.ones_like(base))
    seg = torch.clamp(torch.cumsum(marks[:, :cap], dim=1) - 1, 0, 8)
    pos = (torch.gather(start, 1, seg) + slots[None, :]
           - torch.gather(base, 1, seg))
    cand = order[torch.clamp(pos, 0, n - 1)]                    # (N, C) i32
    slot_ok = slots[None, :] < total[:, None]
    self_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    cand_valid = slot_ok & (cand != self_ids) & valid[:, None]
    return cand, cand_valid, valid


def build_table(points, n_valid, spec: GridSpec):
    """Compacted neighborhood table: (n_cells, neigh_cap) i32 point ids,
    -1 where empty.

    One stable sort by cell id orders the points; per-(cell, offset)
    exclusive prefix sums give each point a slot in the rows of the 27
    cells around it, and one scatter fills the table. Out-of-grid
    neighbours, padding points and slots past ``neigh_cap`` go to one
    trash slot that is dropped (JAX's ``mode='drop'``); every other slot is
    written once.

    Returns (table, cid (N,) i32 per-point cell id, valid (N,) bool).
    """
    n = spec.n_points
    n_cells = spec.n_cells
    cap = spec.neigh_cap
    _, ry, rz = spec.resolution
    dev = points.device
    res = torch.tensor(spec.resolution, dtype=torch.int32, device=dev)
    valid = torch.arange(n, device=dev) < n_valid
    cc, cid = _cells(points, valid, spec)

    order = torch.argsort(cid, stable=True)        # sentinel rows last
    sorted_cid = cid[order].contiguous()
    starts = torch.searchsorted(
        sorted_cid, torch.arange(n_cells + 1, dtype=torch.int32, device=dev))
    counts = starts[1:] - starts[:-1]                           # (n_cells,)
    rank = torch.arange(n, device=dev) - \
        starts[torch.clamp(sorted_cid, 0, n_cells - 1).long()]

    # slot base of offset j in cell c's row: the exclusive prefix sum of
    # the 27 neighbour cells' occupancies
    offs = torch.from_numpy(_OFFSETS).to(dev)
    cell_ids = torch.arange(n_cells, dtype=torch.int32, device=dev)
    cell_cc = torch.stack([cell_ids // (ry * rz), (cell_ids // rz) % ry,
                           cell_ids % rz], dim=-1)              # (n_cells, 3)
    nbr_cc = cell_cc[:, None, :] + offs[None]
    nbr_ok = torch.all((nbr_cc >= 0) & (nbr_cc < res), dim=-1)
    nbr_cid = _flat_cid(torch.minimum(torch.clamp(nbr_cc, min=0), res - 1),
                        spec)
    nbr_counts = torch.where(nbr_ok, counts[nbr_cid.long()], 0)
    base = torch.cumsum(nbr_counts, dim=1) - nbr_counts        # (n_cells, 27)

    # sorted point i (cell c_p, rank m) takes slot base[c', j] + m of every
    # cell c' = c_p - offset_j it neighbours
    sorted_cc = torch.minimum(torch.clamp(cc[order], min=0), res - 1)
    home_cc = sorted_cc[:, None, :] - offs[None]                # (N, 27, 3)
    home_ok = torch.all((home_cc >= 0) & (home_cc < res), dim=-1)
    home_ok &= (sorted_cid < n_cells)[:, None]
    home_cid = _flat_cid(torch.minimum(torch.clamp(home_cc, min=0), res - 1),
                         spec).long()
    j_ids = torch.arange(27, device=dev)[None, :]
    col = base[home_cid, j_ids] + rank[:, None]
    keep = home_ok & (col < cap)
    trash = n_cells * cap
    flat = torch.where(keep, home_cid * cap + col, trash)
    table = torch.full((trash + 1,), -1, dtype=torch.int32, device=dev)
    table.scatter_(0, flat.reshape(-1),
                   order.to(torch.int32)[:, None].expand(n, 27).reshape(-1))
    return table[:trash].reshape(n_cells, cap), cid, valid


def candidate_lists(points, n_valid, spec: GridSpec):
    """Fixed-size per-query candidate ids: the csr layout's packed window
    (:func:`csr_candidate_lists`), or the dense table's row of the query's
    cell (:func:`build_table`).

    Returns (cand_idx (N, C) i32 safe-valued, cand_valid (N, C) bool,
    valid (N,) bool query mask)."""
    if spec.layout == "csr":
        return csr_candidate_lists(points, n_valid, spec)
    if spec.layout != "dense":
        raise ValueError(f"unknown layout {spec.layout!r}")
    table, cid, valid = build_table(points, n_valid, spec)
    cand = table[torch.clamp(cid, 0, spec.n_cells - 1).long()]  # (N, C)
    self_ids = torch.arange(spec.n_points, dtype=torch.int32,
                            device=points.device)[:, None]
    cand_valid = (cand >= 0) & (cand != self_ids) & valid[:, None]
    return torch.clamp(cand, min=0), cand_valid, valid


def knn(points, n_valid, spec: GridSpec):
    """Fixed-degree kNN: (N, 3) points -> ((N, k) idx i32, (N, k) d2,
    (N, k) mask).

    ``n_valid`` is a scalar: points[n_valid:] are padding and are neither
    queried nor returned as neighbors. Missing neighbors have idx -1 and
    mask False.
    """
    if points.shape[0] != spec.n_points:
        raise ValueError(f"points has {points.shape[0]} rows, spec expects "
                         f"{spec.n_points}")
    pts = points.float().contiguous()
    cand_idx, cand_valid, valid = candidate_lists(pts, n_valid, spec)
    cand_pos = pts[cand_idx.long()]
    idx, d2, mask = knn_ops.topk_neighbors(pts, cand_pos, cand_idx,
                                           cand_valid, spec.k)
    mask = mask & valid[:, None]
    idx = torch.where(mask, idx, -1)
    return idx, d2, mask


def symmetric_edges(nbr_idx, nbr_mask):
    """Fixed-shape symmetric closure of (n, k) neighbor lists.

    Forward edges (nbr -> self) plus reverse edges, masking reverse edges
    that duplicate a forward edge (mutual pairs). Returns (senders (2nk,)
    i32, receivers (2nk,) i32, edge_mask (2nk,) bool); masked slots have
    senders = receivers = 0.
    """
    n, k = nbr_idx.shape
    rec = torch.arange(n, dtype=torch.int32,
                       device=nbr_idx.device)[:, None].expand(n, k)
    t = torch.clamp(nbr_idx, min=0).long()
    # reverse edge (i -> t) duplicates a forward edge iff i in nbr[t]
    dup = torch.any((nbr_idx[t] == rec[:, :, None]) & nbr_mask[t], dim=-1)
    rev_mask = nbr_mask & ~dup
    senders = torch.cat([nbr_idx.reshape(-1), rec.reshape(-1)])
    receivers = torch.cat([rec.reshape(-1), nbr_idx.reshape(-1)])
    emask = torch.cat([nbr_mask.reshape(-1), rev_mask.reshape(-1)])
    senders = torch.where(emask, senders, 0).to(torch.int32)
    receivers = torch.where(emask, receivers, 0).to(torch.int32)
    return senders, receivers, emask


# ---------------------------------------------------------------- diagnostics

def neighborhood_counts(pts: np.ndarray, res) -> np.ndarray:
    """3x3x3-neighborhood occupancy of every occupied cell (host numpy,
    O(n) memory regardless of resolution)."""
    res = np.asarray(res, np.int64)
    lo, hi = pts.min(0), pts.max(0)
    extent = np.maximum(hi - lo, 1e-6)
    cc = np.clip(np.floor((pts - lo) / extent * res).astype(np.int64),
                 0, res - 1)
    cid = (cc[:, 0] * res[1] + cc[:, 1]) * res[2] + cc[:, 2]
    occ, counts = np.unique(cid, return_counts=True)
    occ_cc = np.stack([occ // (res[1] * res[2]),
                       (occ // res[2]) % res[1],
                       occ % res[2]], axis=-1)                 # (M, 3)
    nbr = occ_cc[:, None, :] + _OFFSETS[None].astype(np.int64)  # (M, 27, 3)
    ok = np.all((nbr >= 0) & (nbr < res), axis=-1)
    nbr_cid = (nbr[..., 0] * res[1] + nbr[..., 1]) * res[2] + nbr[..., 2]
    idx = np.clip(np.searchsorted(occ, nbr_cid), 0, len(occ) - 1)
    found = (occ[idx] == nbr_cid) & ok
    return np.where(found, counts[idx], 0).sum(axis=1)


def overflow_count(points: np.ndarray, n_valid: int, spec: GridSpec) -> int:
    """Host-side: candidate slots lost to neighborhood-capacity overflow."""
    nc = neighborhood_counts(np.asarray(points)[:n_valid], spec.resolution)
    return int(np.maximum(nc - spec.neigh_cap, 0).sum())


def max_knn_cell_ratio(points: np.ndarray, n_valid: int,
                       spec: GridSpec) -> float:
    """Host-side: max over points of (k-th NN distance / narrowest cell
    width). <= 1.0 guarantees the 27-cell window contains the true kNN
    (exactness, given no overflow). Uses cKDTree: diagnostics only, never
    the hot path."""
    from scipy.spatial import cKDTree
    pts = np.asarray(points)[:n_valid]
    dist, _ = cKDTree(pts).query(pts, k=min(spec.k + 1, len(pts)))
    kth = dist[:, -1]
    widths = np.maximum(pts.max(0) - pts.min(0), 1e-6) / \
        np.asarray(spec.resolution)
    return float(kth.max() / max(widths.min(), 1e-12))
