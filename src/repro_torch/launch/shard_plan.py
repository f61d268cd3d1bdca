"""How large a request's shards are: the halo rings of one request's shard
plan, measured on the host (numpy and cKDTree; nothing runs on a device).

For a sampled car surface of ``--points`` points in ``--shards`` RCB shards
with ``--hops`` halo hops (default ``GNNConfig().n_mp_layers``), prints one
JSON line: ``nmax`` (the largest shard's members, the ring beyond the halo
included, rounded up to 8 as ``build_shard_spec`` caps it),
``nmax_over_owned`` (``nmax`` over the points a shard owns on average),
``nmax_padded`` (the server's cap: ``nmax`` times ``--pad-factor``, default
``GNNConfig().shard_pad_factor``, rounded up to 8, at most the request), the
replication factor (members over points), the halo fraction (members not
owned) and the planning seconds. ``--planner graph`` gives the true hop
rings from the host multi-scale edge list; ``geometric`` the server's box
dilation by the calibrated halo width (``global_halo_width``). A shard of
``nmax`` points holds about ``nmax / n`` of an ``n``-point request's
activations.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.shard_plan --points 262144 \\
      --shards 8 --planner graph
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import GNNConfig
from repro_torch.core import partitioning
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.graphx import hashgrid, sharded
from repro_torch.graphx.multiscale import MultiscaleSpec


def nested_levels(n_points: int, n_levels: int = 3):
    """Nested prefix sizes n/2^(L-1) ... n, as the server's buckets."""
    return tuple(n_points // 2 ** (n_levels - 1 - i) for i in range(n_levels))


def measure(points: np.ndarray, n_shards: int, halo_hops: int,
            level_sizes, k: int, planner: str,
            pad_factor: float = 1.0) -> dict:
    """The membership of one request's shard plan, without the spec
    calibration (``plan_shards`` would also calibrate merged grids)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    t0 = time.perf_counter()
    labels = partitioning.partition_rcb(pts.astype(np.float64), n_shards)
    out = {}
    if planner == "graph":
        mem = sharded._membership_from_graph(pts, labels, n_shards,
                                             level_sizes, k, halo_hops + 1)
    elif planner == "geometric":
        ms = MultiscaleSpec(tuple(level_sizes), k, tuple(
            hashgrid.calibrate_spec(pts[:m], k, n_points=m)
            for m in level_sizes))
        out["halo_width"] = sharded.global_halo_width(pts, ms)
        mem = sharded._membership_geometric(pts, labels, n_shards,
                                            halo_hops + 1, out["halo_width"])
    else:
        raise ValueError(f"unknown planner {planner!r}")
    members = mem["n_local"].astype(np.int64)

    def cap(pad):
        return min(-(-int(np.ceil(int(members.max()) * pad)) // 8) * 8, n)
    nmax = cap(1.0)
    out.update(points=n, shards=n_shards, hops=halo_hops, planner=planner,
               nmax=nmax, nmax_over_owned=nmax / (n / n_shards),
               nmax_padded=cap(pad_factor),
               replication=float(members.sum() / n),
               halo_fraction=float(1 - mem["owned"].sum() / members.sum()),
               seconds=time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--planner", default="graph",
                    choices=["graph", "geometric"])
    ap.add_argument("--hops", type=int, default=None,
                    help="halo hops (default GNNConfig().n_mp_layers)")
    ap.add_argument("--pad-factor", type=float, default=None,
                    help="the cap's headroom (default "
                    "GNNConfig().shard_pad_factor)")
    ap.add_argument("--car", type=int, default=0,
                    help="demo car of data.geometry.sample_params")
    args = ap.parse_args(argv)
    cfg = GNNConfig()
    hops = cfg.n_mp_layers if args.hops is None else args.hops
    verts, faces = geo.car_surface(geo.sample_params(args.car))
    pts, _ = sample_surface(verts, faces, args.points,
                            np.random.default_rng(0))
    pad = cfg.shard_pad_factor if args.pad_factor is None \
        else args.pad_factor
    print(json.dumps(measure(pts, args.shards, hops,
                             nested_levels(args.points), cfg.k_neighbors,
                             args.planner, pad)))


if __name__ == "__main__":
    main()
