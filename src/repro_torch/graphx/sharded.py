"""Sharded serving on tensors: RCB shards with halo rings, one after another.

Port of ``repro.graphx.sharded``. The paper's scalability claim (SIII-A):
partitions with L-hop halos make partitioned execution exactly equal to
full-graph execution. One large request is split by recursive coordinate
bisection (``core.partitioning``) into shards; each shard carries its owned
points plus a halo ring, builds its own multi-scale hash-grid graph (the kNN
kernel, once per level) and runs MeshGraphNet over it (the segment-sum
kernel in every layer). The prediction is masked to owned nodes and gathered
back into one cloud. No shard reads another's values: the halos make each
shard self-contained.

Where the JAX package runs one shard per device under ``shard_map``, this
runs the shards one after another on one device, as the port loops a
batch's rows and a slot table's lanes. The results are the same (no
collective runs in either), and the peak memory is one shard's activations,
not all of them.

Why the halo ring is ``halo_hops + 1`` nodes deep
-------------------------------------------------
Each shard *rebuilds* its graph from points, so a node's local kNN list is
trustworthy only when all of its true neighbours are present locally. Every
kept edge decision (kNN membership, symmetric closure, cross-level dedup)
involves the lists of its two endpoints, and kept edges reach endpoints at
hop ``h``; their neighbours live at hop ``h + 1``. That one extra ring of
*nodes* (kNN candidates only, never senders or receivers) makes every kept
edge match the full graph. Edges are then masked to ``hop(receiver) <= h -
1`` and ``hop(sender) <= h``, the rule of ``core.halo.build_partition``, and
the usual induction gives exact owned outputs for ``h >= n_mp_layers``
(``tests/test_torch_sharded.py``, with the ``h = L - 1`` failure case).

Two planners produce the same layout:

* ``method='graph'``: the true hop sets, from the host multi-scale edge list
  (``core.multiscale``, cKDTree) and ``core.halo``;
* ``method='geometric'``: no graph at all. Every multi-scale edge is at most
  ``halo_width`` long, so dilating the owned RCB box by ``t * halo_width``
  bounds hop ``t`` from below; the memberships are supersets of the true
  rings, which keeps the result exact. The server plans each request this
  way, against a frozen spec.

Plans, their gathers and scatters are host numpy; ``ShardPlan.batch`` puts
a plan's buffers on the device, keeping the per-level valid counts on the
host (the kNN reads them as host integers, so no read waits on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import halo as halo_lib
from repro_torch.core import partitioning
from repro_torch.device import resolve
from repro_torch.graphx import hashgrid
from repro_torch.graphx.multiscale import MultiscaleSpec, multiscale_edges
from repro_torch.graphx.pipeline import (make_featurizer, make_graph_forward,
                                         make_step_fn)

# the batch's device tensors; "level_counts" stays a host numpy array
_DEVICE_KEYS = ("points", "normals", "recv_ok", "send_ok", "owned")
_EPS = 1e-5


@dataclass(frozen=True)
class ShardSpec:
    """Static signature of a sharded inference program.

    ``ms`` is the *per-shard* multi-scale spec: its level sizes are padded
    caps on how many of each global level's points one shard may carry, and
    its grids are calibrated over shard-local clouds. ``halo_width`` is the
    calibrated geometric dilation (see :func:`global_halo_width`) frozen
    with the shapes, so planning a request against this spec never touches
    the full cloud again; ``0.0`` means not calibrated (``graph`` specs).
    """
    n_shards: int
    halo_hops: int
    ms: MultiscaleSpec
    halo_width: float = 0.0

    @property
    def n_points(self) -> int:
        return self.ms.n_points

    def signature(self) -> tuple:
        """Hashable identity of the program this spec drives: the shard and
        halo topology and every shape and grid knob. The server keys its
        bucket cache by ``(size, signature)``, as the JAX server."""
        return (self.n_shards, self.halo_hops, float(self.halo_width),
                tuple(self.ms.level_sizes), self.ms.k,
                tuple((tuple(g.resolution), g.neigh_cap, g.layout)
                      for g in self.ms.grids))


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # from pinned memory, so the copy does not wait for the work still
        # queued on the card (the server's async flush)
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass
class ShardPlan:
    """One request's host-side plan: padded per-shard buffers + bookkeeping."""
    spec: ShardSpec
    global_ids: np.ndarray     # (P, Nmax) int64, padding slots masked
    hop: np.ndarray            # (P, Nmax) int32, padding = HOP_PAD
    owned: np.ndarray          # (P, Nmax) bool
    level_counts: np.ndarray   # (P, L) int32 per-level local valid counts
    points: np.ndarray         # (P, Nmax, 3) float32
    normals: np.ndarray        # (P, Nmax, 3) float32
    n_global: int

    def host_batch(self) -> dict:
        """The (P, ...) numpy arrays of :meth:`batch`."""
        h = self.spec.halo_hops
        return {"points": self.points, "normals": self.normals,
                "level_counts": self.level_counts,
                "recv_ok": self.hop <= h - 1, "send_ok": self.hop <= h,
                "owned": self.owned}

    def batch(self, device=None) -> dict:
        """The (P, ...) batch of :func:`make_sharded_infer_fn` on ``device``
        (default: the card); ``level_counts`` stays on the host."""
        return _to_device(self.host_batch(), resolve(device))

    def gather(self, shard_out) -> np.ndarray:
        """Owned rows of (P, Nmax, F) back into one (n, F) cloud, in one
        masked scatter: ownership partitions the global ids, so the owned
        indices never collide."""
        shard_out = np.asarray(shard_out)
        out = np.zeros((self.n_global,) + shard_out.shape[2:],
                       shard_out.dtype)
        m = self.owned
        out[self.global_ids[m]] = shard_out[m]
        return out

    def scatter(self, values) -> np.ndarray:
        """A global (n, F) array onto the (P, Nmax, F) shard layout.

        Every shard-local row with a real global id, owned or halo, gets its
        global value: what a sharded rollout step with state feedback needs,
        halo rows carrying their owners' current state. Padding rows are
        zero.
        """
        values = np.asarray(values)
        out = values[self.global_ids]
        out[self.hop > self.spec.halo_hops] = 0
        return out


def _to_device(host: dict, device: torch.device) -> dict:
    out = {k: _put(host[k], device) for k in _DEVICE_KEYS}
    out["level_counts"] = np.asarray(host["level_counts"], np.int32)
    return out


@dataclass
class PackPlan:
    """Several geometries of one spec in one sharded call, each its own
    lane with its own :class:`ShardPlan`.

    ``width`` is the most geometries a call takes (the server's
    ``max_batch``). Unlike the JAX package, a call runs only the real
    geometries: :meth:`batch` stacks them to ``(P, G, Nmax, ...)`` with
    ``G = len(plans)``, and no lane replays another. Lanes are independent
    by construction: each builds its own graph from its own points.
    """
    plans: Sequence[ShardPlan]
    width: int

    def __post_init__(self):
        if not self.plans:
            raise ValueError("PackPlan needs at least one ShardPlan")
        if len(self.plans) > self.width:
            raise ValueError(f"{len(self.plans)} plans exceed pack width "
                             f"{self.width}")
        sig = self.plans[0].spec.signature()
        for p in self.plans[1:]:
            if p.spec.signature() != sig:
                raise ValueError("packed plans must share one ShardSpec "
                                 "(one program)")

    @property
    def spec(self) -> ShardSpec:
        return self.plans[0].spec

    def batch(self, device=None) -> dict:
        """The (P, G, ...) batch of :func:`make_sharded_infer_fn`, on
        ``device`` (default: the card)."""
        per = [p.host_batch() for p in self.plans]
        return _to_device({k: np.stack([b[k] for b in per], axis=1)
                           for k in per[0]}, resolve(device))

    def gather(self, shard_out) -> list:
        """Per-geometry owned-node clouds from (P, G, Nmax, F) output."""
        shard_out = np.asarray(shard_out)
        return [plan.gather(shard_out[:, g])
                for g, plan in enumerate(self.plans)]


def pack_plans(plans: Sequence[ShardPlan], width: int) -> PackPlan:
    """Pack same-spec shard plans into one :class:`PackPlan` of ``width``."""
    return PackPlan(plans=list(plans), width=int(width))


# ------------------------------------------------------------------ planning

def global_halo_width(points: np.ndarray, ms: MultiscaleSpec) -> float:
    """Upper bound on any edge length the grid kNN can produce.

    Per level: in the grid's exact regime (the k-th-neighbour distance fits
    the narrowest cell width) every edge is a true kNN edge bounded by that
    width; otherwise the 27-cell search stencil is the only honest bound, two
    cells per axis: ``2 * ||cell_widths||``. One cKDTree query per level
    (host planning, never per dispatch: the server freezes the result into
    ``ShardSpec.halo_width``).
    """
    from scipy.spatial import cKDTree
    pts = np.asarray(points, np.float32)
    width = 0.0
    for n_l, g in zip(ms.level_sizes, ms.grids):
        lvl = pts[: min(n_l, len(pts))]
        extent = np.maximum(lvl.max(0) - lvl.min(0), 1e-6)
        w = extent / np.asarray(g.resolution)
        kth = float(cKDTree(lvl).query(
            lvl, k=min(g.k + 1, len(lvl)))[0][:, -1].max())
        if kth <= w.min():
            width = max(width, float(w.min()))
        else:
            width = max(width, float(2.0 * np.linalg.norm(w)))
    return width


def _membership_from_graph(points: np.ndarray, labels: np.ndarray,
                           n_shards: int, level_sizes: Sequence[int],
                           k: int, ring_hops: int) -> dict:
    """True hop rings from the host multi-scale edge list + ``core.halo``."""
    from repro_torch.core.multiscale import multiscale_edges as host_edges
    s, r, _ = host_edges(points, list(level_sizes), k)
    parts = halo_lib.build_partitions(s, r, labels, n_shards,
                                      halo_hops=ring_hops)
    return halo_lib.export_point_shards(parts)


def _membership_geometric(points: np.ndarray, labels: np.ndarray,
                          n_shards: int, ring_hops: int,
                          halo_width: float) -> dict:
    """Hop lower bounds from RCB-box dilation by ``halo_width`` per hop."""
    pts = np.asarray(points, np.float32)
    w = max(float(halo_width), 1e-12)
    ids, hops, owned = [], [], []
    for p in range(n_shards):
        own = labels == p
        if not own.any():
            ids.append(np.zeros(0, np.int64))
            hops.append(np.zeros(0, np.int32))
            owned.append(np.zeros(0, bool))
            continue
        lo, hi = pts[own].min(0), pts[own].max(0)
        d = np.maximum(np.maximum(lo - pts, pts - hi), 0.0).max(axis=1)
        ghop = np.ceil(d / w - _EPS).astype(np.int32)
        ghop[own] = 0
        member = np.where(ghop <= ring_hops)[0]
        ids.append(member.astype(np.int64))            # already sorted
        hops.append(ghop[member])
        owned.append(own[member])
    return halo_lib.pack_point_shards(ids, hops, owned)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _merge_calibrate(clouds: Sequence[np.ndarray], k: int,
                     n_points: int) -> hashgrid.GridSpec:
    """One GridSpec that is exact for *every* shard's local cloud: the
    elementwise minimum of the per-shard resolutions (widest cells) keeps
    the one-cell window valid for all of them, and the capacity is the
    fullest neighbourhood at that resolution, with ``calibrate_spec``'s
    margin."""
    usable = [np.asarray(c, np.float32) for c in clouds if len(c) > 1]
    if not usable:
        return hashgrid.auto_spec(n_points, k)
    specs = [hashgrid.calibrate_spec(c, k, n_points=n_points)
             for c in usable]
    res = tuple(min(s.resolution[a] for s in specs) for a in range(3))
    occ = max(int(hashgrid.neighborhood_counts(c, res).max())
              for c in usable)
    cap = _round_up(max(int(np.ceil(occ * hashgrid.OCCUPANCY_SAFETY)),
                        2 * k + 2), 128)
    return hashgrid.GridSpec(n_points=n_points, k=k, resolution=res,
                             neigh_cap=min(cap, n_points))


def build_shard_spec(membership: dict, points: np.ndarray,
                     level_sizes: Sequence[int], k: int, n_shards: int,
                     halo_hops: int, *, pad_factor: float = 1.0,
                     halo_width: float = 0.0) -> ShardSpec:
    """Freeze static shapes + local grids from a planned membership.

    ``pad_factor`` > 1 leaves headroom so that similar requests (the
    serving bucket's assumption) fit the same spec.
    """
    pts = np.asarray(points, np.float32)
    ids = membership["global_ids"]
    mask = membership["node_mask"]
    caps, grids = [], []
    for n_l in level_sizes:
        counts = ((ids < n_l) & mask).sum(axis=1)
        cap = max(int(counts.max()), 1)
        cap = min(_round_up(int(np.ceil(cap * pad_factor)), 8), n_l)
        caps.append(cap)
        clouds = [pts[ids[p][(ids[p] < n_l) & mask[p]]]
                  for p in range(ids.shape[0])]
        grids.append(_merge_calibrate(clouds, k, cap))
    # caps are nondecreasing by nestedness; enforce against rounding quirks
    for i in range(1, len(caps)):
        if caps[i] < caps[i - 1]:
            caps[i] = caps[i - 1]
            grids[i] = hashgrid.GridSpec(
                n_points=caps[i], k=k, resolution=grids[i].resolution,
                neigh_cap=min(grids[i].neigh_cap, caps[i]),
                layout=grids[i].layout)
    ms = MultiscaleSpec(level_sizes=tuple(caps), k=k, grids=tuple(grids))
    return ShardSpec(n_shards=n_shards, halo_hops=halo_hops, ms=ms,
                     halo_width=float(halo_width))


def plan_shards(points: np.ndarray, normals: np.ndarray, n_shards: int,
                halo_hops: int, level_sizes: Sequence[int], k: int, *,
                method: str = "graph", halo_width: Optional[float] = None,
                labels: Optional[np.ndarray] = None,
                spec: Optional[ShardSpec] = None,
                pad_factor: float = 1.0) -> ShardPlan:
    """Plan one request's sharded execution (host numpy).

    points/normals: (n, 3) with n == level_sizes[-1] (the nested-prefix
    cloud the single-device pipeline would take). With ``spec`` given, the
    plan is padded to its frozen shapes and raises ``ValueError`` when a
    shard exceeds them (the server's rejection path); otherwise a fresh
    ``ShardSpec`` is calibrated from this request. Under
    ``method='geometric'`` a spec's calibrated ``halo_width`` is the default
    dilation.
    """
    pts = np.asarray(points, np.float32)
    n = len(pts)
    if n != level_sizes[-1]:
        raise ValueError(f"points ({n}) must match finest level "
                         f"({level_sizes[-1]})")
    if halo_hops < 1:
        raise ValueError("halo_hops must be >= 1")
    if labels is None:
        labels = partitioning.partition_rcb(pts.astype(np.float64), n_shards)
    ring = halo_hops + 1
    if method == "graph":
        mem = _membership_from_graph(pts, labels, n_shards, level_sizes, k,
                                     ring)
    elif method == "geometric":
        if halo_width is None and spec is not None and spec.halo_width > 0:
            halo_width = spec.halo_width
        if halo_width is None:
            raise ValueError("method='geometric' needs halo_width (see "
                             "global_halo_width)")
        mem = _membership_geometric(pts, labels, n_shards, ring, halo_width)
    else:
        raise ValueError(f"unknown method {method!r}")

    own_total = int(mem["owned"].sum())
    if own_total != n:
        raise AssertionError(f"ownership not a partition: {own_total} != {n}")

    if spec is None:
        spec = build_shard_spec(mem, pts, level_sizes, k, n_shards,
                                halo_hops, pad_factor=pad_factor,
                                halo_width=halo_width or 0.0)
    elif spec.n_shards != n_shards or spec.halo_hops != halo_hops:
        raise ValueError("spec does not match requested shards/halo")

    nmax = spec.n_points
    ids, mask = mem["global_ids"], mem["node_mask"]
    level_counts = np.stack([((ids < n_l) & mask).sum(axis=1)
                             for n_l in level_sizes], axis=1).astype(np.int32)
    for lvl, cap in enumerate(spec.ms.level_sizes):
        over = level_counts[:, lvl] > cap
        if over.any():
            raise ValueError(
                f"shard capacity exceeded at level {lvl}: "
                f"{int(level_counts[over, lvl].max())} > cap {cap} "
                "(recalibrate the ShardSpec or raise pad_factor)")

    nrm = np.asarray(normals, np.float32)
    out = {
        "global_ids": np.zeros((n_shards, nmax), np.int64),
        "hop": np.full((n_shards, nmax), halo_lib.HOP_PAD, np.int32),
        "owned": np.zeros((n_shards, nmax), bool),
        "points": np.zeros((n_shards, nmax, 3), np.float32),
        "normals": np.zeros((n_shards, nmax, 3), np.float32),
    }
    for p in range(n_shards):
        m = int(mem["n_local"][p])
        sel = ids[p, :m]
        out["global_ids"][p, :m] = sel
        out["hop"][p, :m] = mem["hop"][p, :m]
        out["owned"][p, :m] = mem["owned"][p, :m]
        out["points"][p, :m] = pts[sel]
        out["normals"][p, :m] = nrm[sel]
    return ShardPlan(spec=spec, level_counts=level_counts, n_global=n, **out)


def shard_spec_for(bucket_size: int, n_shards: int, halo_hops: int,
                   pad_factor: float, *, reference_points: np.ndarray,
                   reference_normals: np.ndarray,
                   level_sizes: Sequence[int], k: int,
                   ms: Optional[MultiscaleSpec] = None,
                   method: str = "geometric") -> ShardSpec:
    """The frozen sharded-program parameters for ONE bucket size: per-shard
    level capacities, merged shard-local grids and the geometric halo width,
    all from a reference cloud at the bucket's resolution. Deterministic for
    a fixed reference, so every rebuild of a bucket reproduces the same
    :meth:`ShardSpec.signature`.

    ``ms`` is the bucket's *global* multi-scale spec, used only to bound the
    halo width (:func:`global_halo_width`); when omitted it is calibrated
    from the reference's prefix levels.
    """
    pts = np.asarray(reference_points, np.float32)
    if len(pts) != int(bucket_size) or level_sizes[-1] != int(bucket_size):
        raise ValueError(
            f"reference cloud ({len(pts)}) and finest level "
            f"({level_sizes[-1]}) must both equal bucket_size "
            f"({bucket_size})")
    if ms is None:
        grids = tuple(hashgrid.calibrate_spec(pts[:m], k, n_points=m)
                      for m in level_sizes)
        ms = MultiscaleSpec(level_sizes=tuple(level_sizes), k=k, grids=grids)
    width = global_halo_width(pts, ms) if method == "geometric" else None
    plan = plan_shards(pts, reference_normals, n_shards, halo_hops,
                       level_sizes, k, method=method, halo_width=width,
                       pad_factor=pad_factor)
    return plan.spec


# ----------------------------------------------------------------- execution

def _lanes(batch: dict, sspec: ShardSpec, pack_width: int):
    """``(index, geometry, lane, counts)`` for every (geometry, shard) of a
    batch, geometries outer: ``index`` into the (P[, G], ...) output,
    ``lane`` the shard's device tensors, ``counts`` its per-level valid
    counts."""
    pts = batch["points"]
    packed = pts.dim() == 4
    if pts.dim() not in (3, 4) or pts.shape[0] != sspec.n_shards \
            or pts.shape[-2:] != (sspec.n_points, 3):
        raise ValueError(
            f"sharded batch: points {tuple(pts.shape)} for a spec of "
            f"{sspec.n_shards} shards of {sspec.n_points} points")
    n_geo = pts.shape[1] if packed else 1
    if n_geo > pack_width:
        raise ValueError(f"{n_geo} geometries exceed pack width "
                         f"{pack_width}")
    counts = batch["level_counts"]
    for g in range(n_geo):
        for p in range(sspec.n_shards):
            idx = (p, g) if packed else (p,)
            yield (idx, g, {k: batch[k][idx] for k in _DEVICE_KEYS},
                   counts[idx])


def _shard_edges(lane: dict, counts, ms: MultiscaleSpec):
    """A shard's multi-scale edges (the kNN kernel once per level), masked
    to the halo rule: receivers within ``h - 1`` hops, senders within
    ``h``."""
    pts = lane["points"].float()
    s, r, em = multiscale_edges(pts, counts, ms)
    em = em & lane["send_ok"][s.long()] & lane["recv_ok"][r.long()]
    return pts, torch.where(em, s, 0), torch.where(em, r, 0), em


def make_sharded_infer_fn(cfg: GNNConfig, sspec: ShardSpec, *,
                          norm_in=None, norm_out=None, pack_width: int = 1,
                          device=None):
    """``infer(model, batch) -> (P[, G], Nmax, node_out)`` on ``device``
    (default: the card).

    The batch is a ``ShardPlan.batch()``, (P, ...), or a
    ``PackPlan.batch()``, (P, G, ...) with up to ``pack_width``
    geometries, and the output has the same leading axes
    (``ShardPlan.gather``, ``PackPlan.gather``). For each geometry and each
    shard, one after another: the shard's multi-scale graph with the
    shard-local grids (3 kNN launches), the halo mask, the same
    ``make_graph_forward`` as the single-device pipeline (``n_mp_layers``
    segment-sum launches), and the mask to owned rows. A shard's
    activations are freed before the next shard starts.
    """
    forward = make_graph_forward(cfg, norm_in=norm_in, norm_out=norm_out)
    ms = sspec.ms
    pack_width = int(pack_width)
    dev = resolve(device)

    @torch.no_grad()
    def infer(model, batch):
        lead = tuple(batch["points"].shape[:-2])
        out = torch.empty(lead + (sspec.n_points, cfg.node_out),
                          dtype=torch.float32, device=dev)
        for idx, _, lane, counts in _lanes(batch, sspec, pack_width):
            pts, s, r, em = _shard_edges(lane, counts, ms)
            pred = forward(model, pts, lane["normals"], s, r, em)
            out[idx] = pred * lane["owned"][:, None].to(pred.dtype)
            del pts, s, r, em, pred
        return out

    return infer


def make_sharded_rollout_fn(cfg: GNNConfig, sspec: ShardSpec, *, steps: int,
                            norm_in=None, norm_out=None,
                            pack_width: int = 1):
    """Sharded generate: ``gen(model, batch, state, remaining) -> (state,
    remaining')``.

    ``batch`` is a ``ShardPlan.batch()`` / ``PackPlan.batch()`` (rollout
    lanes on the pack axis G), ``state`` the (P[, G], Nmax, node_out) shard
    layout of ``ShardPlan.scatter`` on the batch's device, written in place,
    and
    ``remaining`` the host steps owed per lane (a count, or (G,) counts).
    For each lane with ``remaining > 0`` and each shard, one after another:
    the shard's graph and features ONCE (3 kNN launches), then ``min(
    remaining, steps)`` physics steps (``n_mp_layers`` segment-sum launches
    each), masked to owned rows. A frozen lane launches nothing; its state
    is only masked to owned rows, as JAX's scan holds it and masks it.
    ``remaining'`` is ``max(remaining - steps, 0)``, on the host.

    With ``rollout_state_feats=False`` the state never re-enters message
    passing, so any ``steps`` per call gives the unsharded rollout on owned
    rows. With state feedback the rings cover one exact step: the rollout
    engine clamps to ``steps=1`` and re-scatters the gathered global state
    between calls (a host-side halo exchange).
    """
    featurize = make_featurizer(cfg, norm_in=norm_in)
    step = make_step_fn(cfg, norm_out=norm_out)
    ms = sspec.ms
    pack_width = int(pack_width)

    @torch.no_grad()
    def gen(model, batch, state, remaining):
        rem = np.asarray(remaining, np.int64)
        for idx, g, lane, counts in _lanes(batch, sspec, pack_width):
            owned = lane["owned"][:, None].to(state.dtype)
            n = int(rem[g] if rem.ndim else rem)
            if n <= 0:
                state[idx].mul_(owned)
                continue
            pts, s, r, em = _shard_edges(lane, counts, ms)
            graph = featurize(pts, lane["normals"], s, r, em)
            st = state[idx]
            for _ in range(min(n, steps)):
                st = step(model, graph, st)
            state[idx].copy_(st * owned)
            del pts, s, r, em, graph, st
        return state, np.maximum(rem - steps, 0)

    return gen
