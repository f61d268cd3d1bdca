"""GNN inference server on PyTorch: geometry in -> surface fields out.

Port of the core of ``repro.launch.serve_gnn.GNNServer``. Requests carry raw
triangle geometry; the server samples a point cloud at the bucket's
resolution (numpy, keyed on ``(seed, request id)`` exactly as the JAX
server, so both sample bit-equal clouds), then runs the bucket's pipeline on
the card: hash-grid kNN at every level (the kNN kernel), the multi-scale
edge union, featurization and the MeshGraphNet forward (the segment-sum
kernel in every layer).

Padding buckets are a static ladder of point counts. Each bucket's grid
specs are calibrated once from a reference geometry (host cKDTree, never per
request). ``flush`` drains the queues synchronously in ascending bucket size,
FIFO, up to ``max_batch`` requests per batch; the rows of a batch run one
after another, and only real requests run (no padding rows).

Trained weights come from a training checkpoint of either package
(``GNNServer.from_checkpoint``, ``--ckpt``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --buckets 16384,65536
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256,512 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256,512 --device cpu --ckpt ckpts/x.msgpack
"""
from __future__ import annotations

import argparse
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.device import resolve
from repro_torch.graphx import hashgrid
from repro_torch.graphx.multiscale import MultiscaleSpec
from repro_torch.graphx.pipeline import make_batched_infer_fn
from repro_torch.models import meshgraphnet
from repro_torch.models.convert import params_from_jax

N_LEVELS = 3        # nested resolution levels per bucket, as in the paper


def _level_sizes(n_points: int, n_levels: int) -> Tuple[int, ...]:
    """Nested prefix sizes n/2^(L-1) ... n (the paper's 500k/1M/2M pattern)."""
    return tuple(n_points // (2 ** (n_levels - 1 - i))
                 for i in range(n_levels))


def load_gnn_checkpoint(path: str, cfg: GNNConfig, device=None):
    """Read a GNN training checkpoint, written by either package's
    ``launch.train``.

    Returns ``(model, norm_in, norm_out)``: the params, in the JAX layout in
    the file, loaded into a :class:`~repro_torch.models.meshgraphnet.
    MeshGraphNet` of ``cfg`` by ``params_from_jax`` on ``device`` (default:
    the card), and the normalizer stats as (mean, std) numpy pairs, ready
    for ``GNNServer(params=..., norm_in=..., norm_out=...)``.
    """
    tree = ckpt.restore(path)
    if "params" not in tree:
        raise ValueError(f"{path} is not a GNN training checkpoint "
                         "(missing 'params')")

    def stats(d):
        if d is None:
            return None
        return (np.asarray(d["mean"], np.float32),
                np.asarray(d["std"], np.float32))

    return (params_from_jax(tree["params"], cfg, device=device),
            stats(tree.get("norm_in")), stats(tree.get("norm_out")))


@dataclass
class Bucket:
    """One padding bucket: static shapes + its batched infer fn."""
    n_points: int
    ms: MultiscaleSpec
    infer: object
    served: int = 0


@dataclass
class Request:
    verts: np.ndarray
    faces: np.ndarray
    request_id: int
    n_points: Optional[int] = None     # desired resolution (bucket-quantized)
    t_submit: float = 0.0


@dataclass
class Result:
    request_id: int
    points: np.ndarray                 # (n, 3) sampled surface points
    fields: np.ndarray                 # (n, node_out) predicted fields
    latency_s: float                   # submit -> result, queueing included
    run_s: float                       # its batch's run -> result
    bucket: int
    batch_size: int


def _percentiles_ms(lat_s) -> dict:
    lat = np.asarray(lat_s)
    if not len(lat):
        return {"p50_ms": 0.0, "p95_ms": 0.0}
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3)}


@dataclass
class ServerStats:
    """Per-request latencies by bucket, batch sizes and serving time.

    ``latency`` runs from submit to result, so it includes the wait behind
    earlier batches of the same flush; ``run`` runs from the start of the
    request's batch to its result."""
    latencies_s: List[float] = field(default_factory=list)
    run_s: List[float] = field(default_factory=list)
    buckets: List[int] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    t_serving: float = 0.0
    overflow_requests: int = 0         # clouds that exceeded a grid's cap
    oversize_requests: int = 0         # asked for more than the ladder's max

    def record(self, results: List[Result]):
        self.latencies_s.extend(r.latency_s for r in results)
        self.run_s.extend(r.run_s for r in results)
        self.buckets.extend(r.bucket for r in results)
        self.batch_sizes.append(len(results))

    def report(self) -> dict:
        n = len(self.latencies_s)
        by_bucket = {}
        for b in sorted(set(self.buckets)):
            sel = [i for i, x in enumerate(self.buckets) if x == b]
            run = _percentiles_ms([self.run_s[i] for i in sel])
            by_bucket[b] = {
                "requests": len(sel),
                **_percentiles_ms([self.latencies_s[i] for i in sel]),
                "run_p50_ms": run["p50_ms"], "run_p95_ms": run["p95_ms"]}
        return {
            "requests": n,
            **_percentiles_ms(self.latencies_s),
            "by_bucket": by_bucket,
            "mean_batch": float(np.mean(self.batch_sizes))
            if self.batch_sizes else 0.0,
            "throughput_rps": n / max(self.t_serving, 1e-9),
            "overflow_requests": self.overflow_requests,
            "oversize_requests": self.oversize_requests,
        }


class GNNServer:
    """Batched multi-geometry inference with a static ladder of padding
    buckets.

    ``params`` is a :class:`~repro_torch.models.meshgraphnet.MeshGraphNet`
    (e.g. from ``models.convert.params_from_jax``); by default random
    weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``norm_in``/``norm_out`` are optional (mean, std) numpy pairs. The
    server runs on ``device`` (default: the card; it raises without one
    unless ``device="cpu"``). Every bucket has ``N_LEVELS`` levels and is
    calibrated from the demo reference car.
    """

    def __init__(self, cfg: GNNConfig, bucket_sizes: Sequence[int] = (1024,),
                 *, params: Optional[meshgraphnet.MeshGraphNet] = None,
                 max_batch: int = 4, norm_in=None, norm_out=None,
                 seed: int = 0, device=None):
        sizes = tuple(sorted(int(b) for b in bucket_sizes))
        if not sizes:
            raise ValueError("the server needs at least one bucket size")
        self.device = resolve(device)
        if self.device.type == "cuda":
            # full f32 matmuls, as the JAX reference computes them (TF32
            # keeps ~3 decimal digits); this is PyTorch's default, set
            # explicitly in case the process enabled it
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.seed = int(seed)
        self._norm_in = norm_in
        self._norm_out = norm_out
        if params is None:
            params = meshgraphnet.init(torch.Generator().manual_seed(seed),
                                       cfg, device=self.device)
        self.params = params.to(self.device).eval()
        # grid specs are calibrated from a reference geometry representative
        # of the traffic
        self._reference = geo.car_surface(geo.sample_params(0))
        self.stats = ServerStats()
        self._next_id = 0
        self._queues: Dict[int, deque] = {n: deque() for n in sizes}
        self._buckets: Dict[int, Bucket] = {n: self._build_bucket(n)
                                            for n in sizes}

    @classmethod
    def from_checkpoint(cls, path: str, cfg: GNNConfig,
                        bucket_sizes: Sequence[int] = (1024,), **kw):
        """Serve trained weights: params and normalizer stats from a
        ``launch.train`` checkpoint of either package."""
        model, norm_in, norm_out = load_gnn_checkpoint(
            path, cfg, device=resolve(kw.get("device")))
        return cls(cfg, bucket_sizes, params=model, norm_in=norm_in,
                   norm_out=norm_out, **kw)

    # ------------------------------------------------------------- buckets

    def _sample_reference(self, n: int):
        """Deterministic n-point sample of the calibration reference."""
        verts, faces = self._reference
        return sample_surface(verts, faces, n, np.random.default_rng(0))

    def _calibrate(self, n: int) -> MultiscaleSpec:
        """Grid calibration for one bucket size (host cKDTree, setup only)."""
        levels = _level_sizes(n, N_LEVELS)
        ref_pts, _ = self._sample_reference(n)
        k = self.cfg.k_neighbors
        grids = tuple(hashgrid.calibrate_spec(ref_pts[:m], k, n_points=m)
                      for m in levels)
        return MultiscaleSpec(level_sizes=levels, k=k, grids=grids)

    def _build_bucket(self, n: int) -> Bucket:
        ms = self._calibrate(n)
        infer = make_batched_infer_fn(self.cfg, ms, norm_in=self._norm_in,
                                      norm_out=self._norm_out)
        return Bucket(n_points=n, ms=ms, infer=infer)

    def ladder(self) -> Tuple[int, ...]:
        return tuple(sorted(self._buckets))

    def bucket_for(self, n_points: Optional[int]) -> int:
        """Smallest bucket that fits ``n_points`` (``None``: the largest);
        an oversize ask is served downsampled at the largest bucket."""
        sizes = self.ladder()
        if n_points is None:
            return sizes[-1]
        for s in sizes:
            if n_points <= s:
                return s
        return sizes[-1]

    # ------------------------------------------------------------- serving

    def submit(self, verts: np.ndarray, faces: np.ndarray,
               n_points: Optional[int] = None) -> int:
        """Enqueue a geometry; returns the request id."""
        bucket = self.bucket_for(n_points)
        if n_points is not None and n_points > bucket:
            self.stats.oversize_requests += 1
            warnings.warn(f"request for {n_points} points exceeds the "
                          f"largest bucket ({bucket}): serving a "
                          f"downsampled {bucket}-point cloud")
        rid = self._next_id
        self._next_id += 1
        self._queues[bucket].append(Request(
            verts=np.asarray(verts, np.float32), faces=np.asarray(faces),
            request_id=rid, n_points=n_points, t_submit=time.perf_counter()))
        return rid

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def warmup(self):
        """Run each bucket once on ``max_batch`` copies of the reference
        geometry (not recorded in the stats)."""
        verts, faces = self._reference
        for n in self.ladder():
            batch = [Request(verts, faces, -1, n)] * self.max_batch
            self._run_batch(self._buckets[n], batch, record=False)

    def _sample(self, req: Request, n: int):
        # deterministic per (server seed, request id): independent of what
        # other traffic or warmup ran before this request
        rng = np.random.default_rng((self.seed, req.request_id + 1))
        return sample_surface(req.verts, req.faces, n, rng)

    def _check_cloud(self, b: Bucket, pts: np.ndarray, rid: int) -> int:
        """Numpy guard against clouds denser than the calibration reference,
        which would overflow a grid's candidate capacity and silently drop
        kNN candidates."""
        dropped = sum(hashgrid.overflow_count(pts[:m], m, g)
                      for m, g in zip(b.ms.level_sizes, b.ms.grids))
        if dropped:
            self.stats.overflow_requests += 1
            warnings.warn(f"request {rid}: geometry overflows bucket "
                          f"{b.n_points}'s calibrated grid ({dropped} "
                          "candidate slots dropped); neighbor sets may be "
                          "approximate")
        return dropped

    def _run_batch(self, b: Bucket, reqs: List[Request],
                   record: bool = True) -> List[Result]:
        """Sample, run the bucket's pipeline on the card, copy back."""
        n = b.n_points
        t_run = time.perf_counter()
        samples = [self._sample(r, n) for r in reqs]
        if record:
            for (pts, _), r in zip(samples, reqs):
                self._check_cloud(b, pts, r.request_id)
        pts = np.stack([p for p, _ in samples])
        nrm = np.stack([m for _, m in samples])
        out = b.infer(self.params,
                      torch.from_numpy(pts).to(self.device),
                      torch.from_numpy(nrm).to(self.device),
                      [n] * len(reqs))
        fields = out.cpu().numpy()         # waits for the card
        t_done = time.perf_counter()
        results = [Result(request_id=r.request_id, points=pts[i],
                          fields=fields[i],
                          latency_s=t_done - (r.t_submit or t_done),
                          run_s=t_done - t_run, bucket=n,
                          batch_size=len(reqs))
                   for i, r in enumerate(reqs)]
        if record:
            self.stats.record(results)
            b.served += len(reqs)
        return results

    def flush(self) -> List[Result]:
        """Drain every queue, up to ``max_batch`` requests per batch, in
        ascending bucket size, FIFO within a bucket."""
        t0 = time.perf_counter()
        results: List[Result] = []
        for n in self.ladder():
            q = self._queues[n]
            while q:
                batch = [q.popleft() for _ in range(min(len(q),
                                                        self.max_batch))]
                results.extend(self._run_batch(self._buckets[n], batch))
        self.stats.t_serving += time.perf_counter() - t0
        return results

    def serve(self, requests: Sequence[Tuple[np.ndarray, np.ndarray,
                                             Optional[int]]]) -> List[Result]:
        """Submit + flush a stream of (verts, faces, n_points) requests."""
        for verts, faces, n_points in requests:
            self.submit(verts, faces, n_points)
        return self.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--buckets", default="16384,65536",
                    help="comma-separated static ladder of point counts")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (hidden 64, 3 layers)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="serve the params and normalizers of this "
                    "launch.train checkpoint (either package's; its config "
                    "must match --reduced) instead of random weights")
    args = ap.parse_args(argv)

    cfg = GNNConfig().reduced() if args.reduced else GNNConfig()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    dev = resolve(args.device)
    kw = dict(max_batch=args.max_batch, seed=args.seed, device=dev)
    if args.ckpt:
        server = GNNServer.from_checkpoint(args.ckpt, cfg, buckets, **kw)
        print(f"loaded checkpoint {args.ckpt}")
    else:
        server = GNNServer(cfg, buckets, **kw)
    t0 = time.perf_counter()
    server.warmup()
    print(f"warmup ({len(buckets)} buckets): {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(args.requests):
        verts, faces = geo.car_surface(geo.sample_params(i))
        reqs.append((verts, faces, int(rng.choice(buckets))))
    results = server.serve(reqs)
    rep = server.stats.report()
    print(f"served {rep['requests']} requests on {dev} | "
          f"p50 {rep['p50_ms']:.1f} ms | p95 {rep['p95_ms']:.1f} ms | "
          f"mean batch {rep['mean_batch']:.1f} | "
          f"{rep['throughput_rps']:.2f} req/s")
    for n, bb in rep["by_bucket"].items():
        print(f"  bucket {n}: {bb['requests']} requests | submit->result "
              f"p50 {bb['p50_ms']:.1f} ms p95 {bb['p95_ms']:.1f} ms | "
              f"batch run p50 {bb['run_p50_ms']:.1f} ms")
    for r in results[:3]:
        cp = r.fields[:, 0]
        print(f"  req {r.request_id}: bucket {r.bucket}, "
              f"cp range [{cp.min():.2f}, {cp.max():.2f}]")


if __name__ == "__main__":
    main()
