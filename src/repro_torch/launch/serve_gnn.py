"""GNN inference server on PyTorch: geometry in -> surface fields out.

Port of ``repro.launch.serve_gnn.GNNServer``. Requests carry raw triangle
geometry; the server samples a point cloud at the bucket's
resolution (numpy, keyed on ``(seed, request id)`` exactly as the JAX
server, so both sample bit-equal clouds), then runs the bucket's pipeline on
the card: hash-grid kNN at every level (the kNN kernel), the multi-scale
edge union, its compaction to the valid edges, featurization and the
MeshGraphNet forward over them (the segment-sum kernel in every layer).

Padding buckets: request sizes are quantized to a ladder of point counts.
Each bucket's grid specs are calibrated once per size from a reference
geometry (host cKDTree, never per request) and cached in ``_calib``, so an
evicted bucket that comes back never recalibrates. The ladder is static or,
with ``bucket_sizes="auto"`` (or ``cfg.bucket_policy == "auto"``), derived
from traffic: an oversize request grows the ladder, every
``cfg.bucket_refit_every`` submits a quantile refit retargets it, and beyond
``cfg.max_live_buckets`` the least-recently-used idle bucket is evicted and
rebuilt on demand. The policy, its counters and the order of its decisions
are the JAX server's, so the same traffic gives the same ladder. A bucket
here holds no device memory (the eager pipeline allocates per call), so
eviction bounds host objects only. On a static ladder an oversize request
is served downsampled at the largest bucket with a warning, or rejected
with ``Result.error`` under ``reject_overflow=True``.

Microbatching: ``flush`` drains the queues in ascending bucket size, FIFO
within a bucket, up to ``max_batch`` requests per batch. The rows of a
batch run one after another, and only real requests run: a partial batch is
not padded with replay rows as in the JAX server (which pads to
``max_batch`` so that each bucket compiles once), so ``padding_points``
counts no replay rows here.

Async double-buffered flush (the default): batch ``j`` is copied to the card
from pinned memory, its pipeline is enqueued, its result is copied back
into pinned memory behind it and a ``torch.cuda.Event`` is recorded. The
dispatch waits for the card once, after every row's graph is built and
before any forward is enqueued (``compact``: the rows' valid-edge
counts), and returns without waiting for the forwards. The host then
samples batch ``j + 1`` while the card runs batch ``j``, waits on ``j``'s
event and dispatches ``j + 1`` (the JAX server dispatches ``j + 1``
first: see ``_run_plan``). ``async_flush=False`` samples each batch only
after the previous one has finished.

Background serving: ``start(deadline_s=...)`` spawns a supervised worker
thread that flushes a bucket as soon as it holds ``max_batch`` requests or
its oldest request has waited ``deadline_s``; ``result(rid)`` blocks until
that request lands. Per-request deadlines drop a request before any device
work; bounded admission (``max_queue_depth``) sheds or blocks producers; a
bucket whose build or call raises is quarantined and its batch served by
the next larger size; a harvested result with NaN/Inf is resolved as an
error (``cfg.nonfinite_guard``). Errors raised asynchronously by the card
surface at the harvest, as an error of that batch; nothing falls back to
the CPU.

``ServerStats`` streams latencies, batch sizes and the ``SERVE_STAGES``
timings into histograms of the server's ``telemetry.metrics``; with
``cfg.telemetry`` the tracer records the per-request spans, and while a
``torch.profiler`` profile records they land in ``telemetry.PROFILED`` from
every thread. The worker's spans wrap its work: ``flush``; ``prepare``,
with a ``sample`` and a ``check_cloud`` per request; ``dispatch``, with
``h2d`` (the stack and the pinned copies) and ``enqueue`` (the bucket
call, with the pipeline's ``compact`` inside); ``device_wait``;
``harvest``; ``publish``; and ``await_work``, its wait for the next
plan. ``submit``, ``bucket_route``, ``queue_wait``, ``request`` and
``result`` cross threads and are recorded afterwards.

Sharded serving (``shard_devices > 1``): each request is split into
``shard_devices`` RCB shards with halo rings (``repro_torch.graphx.
sharded``), which run one after another on the server's device, each
building its own graph (the kNN kernel, once per level) and running the
model over it (the segment-sum kernel in every layer); the owned rows are
gathered back into one cloud. The JAX server runs one shard per device
under ``shard_map``; no collective runs in either, so the fields are the
same, and here the peak memory is one shard's. A bucket's ``ShardSpec``
(per-shard level capacities, merged shard-local grids, the calibrated halo
width) is derived once per size from the reference geometry and cached in
``_shard_calib`` like ``_calib``; each request is planned against it with
the ``geometric`` planner (host numpy). A request whose shards outgrow the
bucket's spec, or whose plan fails, is rejected with ``Result.error``, and
only that request. Up to ``max_batch`` geometries share one call, each its
own lane.

Trained weights come from a training checkpoint of either package
(``GNNServer.from_checkpoint``, ``--ckpt``).

Cold start: ``save_artifact`` freezes a server's params, normalizers,
ladder, request-size histogram and every calibrated ``MultiscaleSpec`` and
``ShardSpec`` into one deploy artifact (``repro_torch.ckpt.artifact``, the
JAX package's format); ``from_artifact`` restores it, or a JAX-written one,
and never calibrates. ``cfg.compile_cache_dir`` (``--compile-cache``)
points the CUDA kernels' build directory at a cache that outlives the
process (``repro_torch.ckpt.compile_cache``): a restarted server loads the
kernels from it instead of running ``nvcc``. A bucket's first call counts
its ``nvcc`` runs as ``bucket_compiles`` and its libraries loaded from
disk as ``cache_loads``.

T-step rollouts (``rollout``, ``submit_rollout``, ``rollout_result``,
``--rollout-steps``) run through the server's ``RolloutEngine``
(``repro_torch.launch.rollout``), on the same ladder, ids and device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --buckets 16384,65536
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256,512 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets auto --device cpu --sync --request-timeout 30
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256,512 --device cpu --ckpt ckpts/x.msgpack
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256 --device cpu --rollout-steps 20 --rollout-slots 4 \
      --integrator residual
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256 --device cpu --shard-devices 4
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --reduced \
      --buckets 256,512 --device cpu --save-artifact build/deploy.msgpack
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu \
      --artifact build/deploy.msgpack --compile-cache build/kernel_cache
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.ckpt import artifact as artifact_lib
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import compile_cache
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.device import resolve
from repro_torch.graphx import hashgrid, sharded
from repro_torch.graphx.multiscale import MultiscaleSpec
from repro_torch.graphx.pipeline import make_batched_infer_fn
from repro_torch.models import meshgraphnet
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.resilience import faults
from repro_torch.telemetry import (Histogram, MetricsRegistry, Telemetry,
                                   clock_ns, default_size_buckets, warn_once)

log = logging.getLogger(__name__)

N_LEVELS = 3        # nested resolution levels per bucket by default, as in
                    # the paper (``GNNServer(n_levels=...)``)

# serving-lifecycle stages recorded per batch/request (ServerStats stage
# histograms + the per-request trace spans): submit -> queue_wait ->
# bucket_route -> prepare -> dispatch -> device_wait -> harvest -> result.
# ``compile`` / ``cache_load``: a bucket's first call that built (nvcc) or
# loaded a CUDA kernel; empty once every kernel is loaded, and on the CPU.
SERVE_STAGES = ("queue_wait", "prepare", "dispatch", "device_wait",
                "harvest", "compile", "cache_load")


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
    """One padding bucket: static shapes + its infer fn (the batched
    pipeline, or in sharded mode ``graphx.sharded.make_sharded_infer_fn``
    of ``sspec``)."""
    n_points: int
    ms: MultiscaleSpec
    infer: object
    served: int = 0
    last_used: int = 0                 # LRU tick (autoscaler eviction order)
    sspec: Optional[sharded.ShardSpec] = None   # sharded mode only
    plan_sig: Optional[tuple] = None   # sspec.signature(): the cache key's
                                       # second half in sharded mode
    called: bool = False               # its first call has run (compiles
                                       # and cache loads are counted there)
    edges: list = field(default_factory=list)   # valid edges a row, one
                                       # list a call, from the pipeline


@dataclass
class Request:
    verts: np.ndarray
    faces: np.ndarray
    request_id: int
    n_points: Optional[int] = None     # desired resolution (bucket-quantized)
    t_submit: float = 0.0
    deadline: Optional[float] = None   # perf_counter() time after which the
                                       # request is dropped, not served
    t_submit_ns: int = 0               # t_submit on the span clock


@dataclass
class Result:
    request_id: int
    points: np.ndarray                 # (n, 3) sampled surface points
    fields: np.ndarray                 # (n, node_out) predicted fields
    latency_s: float                   # submit -> result, queueing included
    bucket: int
    batch_size: int
    error: Optional[str] = None        # set on rejected requests (fields NaN
                                       # or empty)
    run_s: float = 0.0                 # its batch's run (see _harvest)


@dataclass
class ServerStats:
    """Serving counters + bounded streaming timing stats (the JAX server's).

    Latencies, batch sizes and per-stage timings stream into fixed-bucket
    histograms in ``metrics`` (a :class:`repro_torch.telemetry.
    MetricsRegistry`): O(n_buckets) memory under unbounded traffic. A
    bounded recent window (``recent_cap`` newest values) backs
    :attr:`latencies_s` / :attr:`batch_sizes`. Per padding bucket, two more
    histograms (kept off the registry) hold the submit -> result latency and
    the batch's own run (``Result.run_s``) for ``report()["by_bucket"]``.

    ``bucket_compiles`` and ``cache_loads`` count, over each bucket's first
    call, the CUDA kernels that call built with ``nvcc`` and those it loaded
    from the build directory (``repro_torch.ckpt.compile_cache``); the
    ``compile`` / ``cache_load`` stages hold those calls' times. Both stay 0
    once every kernel is loaded, and on the CPU.

    ``edges_computed`` counts the valid edges of the rows served, over
    which the model runs, and ``edge_slots`` the fixed-shape union's slots
    of those rows (``ms.n_edges`` each); ``report()["edge_compute_frac"]``
    is their ratio. Sharded buckets count neither.

    Scalar counter mutations and :meth:`report` synchronize on ``lock``;
    histograms carry their own locks.
    """
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    recent_cap: int = 1024
    t_serving: float = 0.0
    overflow_requests: int = 0         # clouds that exceeded a grid's cap
    rejected_requests: int = 0         # returned with Result.error set
    oversize_requests: int = 0         # asked for more than the static ladder
    bucket_hits: int = 0               # served by an already-live bucket
    bucket_misses: int = 0             # bucket had to be (re)built
    bucket_evictions: int = 0          # cold buckets dropped (LRU)
    bucket_compiles: int = 0           # nvcc runs in buckets' first calls
    cache_loads: int = 0               # kernels loaded from the build dir
    bucket_calibrations: int = 0       # host cKDTree grid calibrations run
    grown_buckets: int = 0             # ladder sizes added for oversize asks
    padding_points: int = 0            # computed-but-unrequested points
    requested_points: int = 0          # points actually asked for
    edge_slots: int = 0                # union slots of the rows served
    edges_computed: int = 0            # of them, valid: the model's rows
    # resilience counters (each mirrored to a Prometheus counter
    # serve_<name>_total via bump(), so monitors see them live)
    timed_out_requests: int = 0        # deadline expired before device work
    rejected_overload: int = 0         # shed by bounded admission control
    nonfinite_results: int = 0         # NaN/Inf caught at harvest
    worker_crashes: int = 0            # _serve_loop died (supervised)
    worker_restarts: int = 0           # supervisor restarts after a crash
    quarantined_buckets: int = 0       # sizes pulled after build/call fail
    bucket_fallbacks: int = 0          # batches served by a larger bucket
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    _RESILIENCE = ("timed_out_requests", "rejected_overload",
                   "nonfinite_results", "worker_crashes", "worker_restarts",
                   "quarantined_buckets", "bucket_fallbacks")

    def __post_init__(self):
        self._recent_lat: deque = deque(maxlen=self.recent_cap)
        self._recent_batch: deque = deque(maxlen=self.recent_cap)
        self._bind_metrics()

    def _bind_metrics(self):
        m = self.metrics
        self._h_latency = m.histogram(
            "serve_request_latency_seconds",
            help="submit->result latency per served request")
        self._h_batch = m.histogram(
            "serve_batch_size", buckets=default_size_buckets(1, 4096),
            help="requests per dispatched microbatch")
        self._h_stage = {
            s: m.histogram(f"serve_{s}_seconds",
                           help=f"serving stage time: {s}")
            for s in SERVE_STAGES}
        self._counters = {
            name: m.counter(f"serve_{name}_total",
                            help=f"resilience counter: {name}")
            for name in self._RESILIENCE}
        self.g_worker_alive = m.gauge(
            "serve_worker_alive",
            help="1 while the background serve worker is running")
        self.g_queue_depth = m.gauge(
            "serve_queue_depth", help="requests currently queued")
        self.g_last_flush = m.gauge(
            "serve_last_flush_timestamp",
            help="unix time the worker last published results")
        # per bucket: (submit->result latency, the batch's own run)
        self._h_bucket: Dict[int, Tuple[Histogram, Histogram]] = {}

    def bump(self, name: str, n: int = 1):
        """Increment a resilience counter (scalar field + Prometheus)."""
        with self.lock:
            setattr(self, name, getattr(self, name) + n)
        self._counters[name].inc(n)

    # ------------------------------------------------------------ recording

    @property
    def latencies_s(self) -> List[float]:
        """Recent-window request latencies (bounded; newest ``recent_cap``)."""
        with self.lock:
            return list(self._recent_lat)

    @property
    def batch_sizes(self) -> List[int]:
        """Recent-window dispatched batch sizes (bounded)."""
        with self.lock:
            return list(self._recent_batch)

    def record_latency(self, lat_s: float):
        self._h_latency.observe(lat_s)
        with self.lock:
            self._recent_lat.append(lat_s)

    def record_request(self, bucket: int, lat_s: float, run_s: float):
        """One served request: the latency histograms, overall and of its
        bucket, and its batch's run."""
        self.record_latency(lat_s)
        with self.lock:
            hs = self._h_bucket.get(bucket)
            if hs is None:
                hs = self._h_bucket[bucket] = (
                    Histogram(f"bucket_{bucket}_latency"),
                    Histogram(f"bucket_{bucket}_run"))
        hs[0].observe(lat_s)
        hs[1].observe(run_s)

    def record_batch(self, size: int):
        self._h_batch.observe(size)
        with self.lock:
            self._recent_batch.append(int(size))

    def record_stage(self, stage: str, dt_s: float):
        """One observation of a lifecycle stage (see ``SERVE_STAGES``)."""
        h = self._h_stage.get(stage)
        if h is None:
            h = self._h_stage[stage] = self.metrics.histogram(
                f"serve_{stage}_seconds",
                help=f"serving stage time: {stage}")
        h.observe(dt_s)

    def reset(self):
        """Zero every counter and histogram (keeps the lock and registry
        identity)."""
        with self.lock:
            self.t_serving = 0.0
            self.overflow_requests = 0
            self.rejected_requests = 0
            self.oversize_requests = 0
            self.bucket_hits = 0
            self.bucket_misses = 0
            self.bucket_evictions = 0
            self.bucket_compiles = 0
            self.cache_loads = 0
            self.bucket_calibrations = 0
            self.grown_buckets = 0
            self.padding_points = 0
            self.requested_points = 0
            self.edge_slots = 0
            self.edges_computed = 0
            for name in self._RESILIENCE:
                setattr(self, name, 0)
            self._recent_lat.clear()
            self._recent_batch.clear()
        self.metrics.reset()
        self._bind_metrics()

    def stage_report(self) -> dict:
        """Per-stage latency breakdown from the streaming histograms:
        ``{stage: {count, mean_ms, p50_ms, p95_ms, total_s}}``."""
        out = {}
        for s, h in sorted(self._h_stage.items()):
            n = h.count
            out[s] = {
                "count": n,
                "mean_ms": h.mean * 1e3,
                "p50_ms": (h.percentile(50) * 1e3) if n else 0.0,
                "p95_ms": (h.percentile(95) * 1e3) if n else 0.0,
                "total_s": h.sum,
            }
        return out

    def bucket_report(self) -> dict:
        """``{bucket: {requests, mean_ms, p50_ms, p95_ms, run_mean_ms,
        run_p50_ms, run_p95_ms}}`` from the per-bucket histograms.
        Percentiles interpolate inside a histogram bucket (about 23 % wide)
        and are clamped to the observed range; the means are exact."""
        with self.lock:
            items = sorted(self._h_bucket.items())
        out = {}
        for b, (lat, run) in items:
            out[b] = {"requests": lat.count,
                      "mean_ms": lat.mean * 1e3,
                      "p50_ms": lat.percentile(50) * 1e3,
                      "p95_ms": lat.percentile(95) * 1e3,
                      "run_mean_ms": run.mean * 1e3,
                      "run_p50_ms": run.percentile(50) * 1e3,
                      "run_p95_ms": run.percentile(95) * 1e3}
        return out

    def report(self) -> dict:
        with self.lock:                # snapshot: the worker may be appending
            t_serving = self.t_serving
            counters = {
                "overflow_requests": self.overflow_requests,
                "rejected_requests": self.rejected_requests,
                "oversize_requests": self.oversize_requests,
                "bucket_hits": self.bucket_hits,
                "bucket_misses": self.bucket_misses,
                "bucket_evictions": self.bucket_evictions,
                "bucket_compiles": self.bucket_compiles,
                "cache_loads": self.cache_loads,
                "bucket_calibrations": self.bucket_calibrations,
                "grown_buckets": self.grown_buckets,
                "edge_slots": self.edge_slots,
                "edges_computed": self.edges_computed,
            }
            counters.update({name: getattr(self, name)
                             for name in self._RESILIENCE})
            padded = self.padding_points
            requested = self.requested_points
        n = self._h_latency.count
        # empty case: explicit zeros, never percentiles of fabricated data
        rep = {
            "requests": n,
            "p50_ms": self._h_latency.percentile(50) * 1e3 if n else 0.0,
            "p95_ms": self._h_latency.percentile(95) * 1e3 if n else 0.0,
            "p99_ms": self._h_latency.percentile(99) * 1e3 if n else 0.0,
            "mean_batch": self._h_batch.mean,
            "throughput_rps": n / max(t_serving, 1e-9),
            "padding_waste_frac": padded / max(padded + requested, 1),
            "edge_compute_frac": (counters["edges_computed"]
                                  / max(counters["edge_slots"], 1)),
            "stages": self.stage_report(),
            "by_bucket": self.bucket_report(),
        }
        rep.update(counters)
        return rep


@dataclass
class _InFlight:
    """One dispatched batch: host bookkeeping + the un-synced device output.

    Created by ``_dispatch`` (which returns before the card finishes),
    consumed by ``_harvest`` (which waits on ``event``). ``host`` is the
    output's destination, pinned host memory filled by an asynchronous copy
    enqueued behind the batch (on the CPU: the output itself). ``results``
    carries rejections resolved at prepare time, in submission order.
    """
    bucket: Optional[Bucket]           # None on all-rejected error items
    results: List[Result]
    ok_reqs: List[Request]
    host: object                       # output tensor on the host, or None
    pts: np.ndarray                    # host copy of the sampled clouds
    record: bool
    event: object = None               # torch.cuda.Event after the copy
    start_event: object = None         # torch.cuda.Event before the batch
    t_start: float = 0.0               # its prepare began (perf_counter)
    t_dispatched: float = 0.0          # its dispatch returned
    plan: object = None                # sharded mode: the PackPlan
    edges: Optional[List[int]] = None  # valid edges a row (not sharded)


class GNNServer:
    """Batched multi-geometry inference with padding buckets.

    ``params`` is a :class:`~repro_torch.models.meshgraphnet.MeshGraphNet`
    (e.g. from ``models.convert.params_from_jax``); by default random
    weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``norm_in``/``norm_out`` are optional (mean, std) numpy pairs. The
    server runs on ``device`` (default: the card; it raises without one
    unless ``device="cpu"``). Every bucket has ``n_levels`` levels (default
    ``N_LEVELS``: the kNN kernel launches once a level) and is calibrated
    from ``reference`` (verts, faces), by default the demo car.
    ``check_requests=False`` skips the numpy overflow guard
    (:meth:`_check_cloud`) of each request, as the JAX server's does.

    ``bucket_sizes`` is a static ladder or ``"auto"`` (see the module
    docstring); a ladder together with ``cfg.bucket_policy == "auto"`` seeds
    the autoscaler. The resilience knobs default to the config's fields of
    the same names. ``shard_devices > 1`` serves every request in that many
    shards, one after another on ``device`` (JAX's name is kept: there it
    counts devices), with ``shard_pad_factor`` (default
    ``cfg.shard_pad_factor``) of headroom in each bucket's shard shapes.
    The JAX server's ``knn_impl``, ``agg_impl``, ``interpret`` and
    ``donate`` have no counterpart (the kernels dispatch by device).
    ``_restore`` is the state
    :meth:`from_artifact` hands over (calibrated specs, ladder, histogram).
    """

    def __init__(self, cfg: GNNConfig,
                 bucket_sizes: Union[str, Sequence[int]] = (1024,),
                 *, params: Optional[meshgraphnet.MeshGraphNet] = None,
                 max_batch: int = 4, n_levels: int = N_LEVELS,
                 norm_in=None, norm_out=None,
                 seed: int = 0, reference=None, check_requests: bool = True,
                 reject_overflow: bool = False, async_flush: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 request_timeout_s: Optional[float] = None,
                 worker_max_restarts: Optional[int] = None,
                 shard_devices: int = 1,
                 shard_pad_factor: Optional[float] = None, device=None,
                 _restore: Optional[dict] = None):
        self.device = resolve(device)
        # the kernels' build directory: a restarted process loads the
        # libraries an earlier one built there instead of running nvcc
        compile_cache.enable(cfg.compile_cache_dir)
        if self.device.type == "cuda":
            # full f32 matmuls, as the JAX reference computes them (TF32
            # keeps ~3 decimal digits); this is PyTorch's default, set
            # explicitly in case the process enabled it
            torch.backends.cuda.matmul.allow_tf32 = False
        if cfg.bucket_policy not in ("static", "auto"):
            raise ValueError(
                f"cfg.bucket_policy must be 'static' or 'auto', "
                f"got {cfg.bucket_policy!r}")
        self.auto = bucket_sizes == "auto" or cfg.bucket_policy == "auto"
        seed_sizes = () if bucket_sizes == "auto" else \
            tuple(sorted(int(b) for b in bucket_sizes))
        if not self.auto and not seed_sizes:
            raise ValueError("a static server needs at least one bucket "
                             "size (or pass bucket_sizes='auto')")
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.n_levels = int(n_levels)
        if self.n_levels < 1:
            raise ValueError(f"n_levels must be >= 1, got {n_levels}")
        self.check_requests = bool(check_requests)
        self.reject_overflow = reject_overflow
        self.shard_devices = int(shard_devices)
        self.shard_pad_factor = float(cfg.shard_pad_factor
                                      if shard_pad_factor is None
                                      else shard_pad_factor)
        self.async_flush = bool(async_flush)
        self.seed = int(seed)
        self._norm_in = norm_in
        self._norm_out = norm_out
        if params is None:
            params = meshgraphnet.init(torch.Generator().manual_seed(seed),
                                       cfg, device=self.device)
        self.params = params.to(self.device).eval()
        self._queues: Dict[int, deque] = {}
        self._buckets: Dict[int, Bucket] = {}
        self._ladder: set = set(seed_sizes)   # target sizes (incl. not-live)
        # calibration cache: one MultiscaleSpec per size, kept across LRU
        # evictions — an evict->rebuild never recalibrates
        self._calib: Dict[int, MultiscaleSpec] = {}
        # sharded sibling of _calib: one frozen ShardSpec per bucket size
        # (per-shard capacities, merged grids, halo width), kept likewise
        self._shard_calib: Dict[int, sharded.ShardSpec] = {}
        self._size_hist: deque = deque(maxlen=max(int(cfg.bucket_hist_len),
                                                  1))
        self._refit_count = 0
        self._tick = 0                        # LRU clock for bucket eviction
        self._plan_sizes: set = set()         # sizes in the active drain plan
        # telemetry: span tracer gated by cfg.telemetry (no-op object when
        # off), metrics registry always live — it backs ServerStats
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.from_config(cfg))
        self.stats = ServerStats(metrics=self.telemetry.metrics)
        self._warn_once = warn_once(log)
        self._next_id = 0
        self._cond = threading.Condition()
        self._serve_lock = threading.Lock()
        self._done: Dict[int, Result] = {}
        self._done_cap = 4096
        self._waiting: set = set()        # rids with a blocked result() call
        self._worker: Optional[threading.Thread] = None
        self._stop_flag = False
        self._deadline_s = 0.0
        self.max_queue_depth = int(cfg.max_queue_depth
                                   if max_queue_depth is None
                                   else max_queue_depth)
        self.shed_policy = (cfg.shed_policy if shed_policy is None
                            else shed_policy)
        if self.shed_policy not in ("reject", "block"):
            raise ValueError("shed_policy must be 'reject' or 'block', "
                             f"got {self.shed_policy!r}")
        self.request_timeout_s = float(cfg.request_timeout_s
                                       if request_timeout_s is None
                                       else request_timeout_s)
        self.worker_max_restarts = int(cfg.worker_max_restarts
                                       if worker_max_restarts is None
                                       else worker_max_restarts)
        self._quarantined: set = set()    # sizes pulled after build/call
                                          # failures (excluded from routing)
        self._inflight: List[Request] = []  # popped from queues, result not
                                            # yet published (crash cleanup)
        self._worker_dead = False         # supervision gave up: every submit
                                          # resolves to an immediate error
        self._restarts = 0
        self._rollout = None              # lazy RolloutEngine (rollout_engine)
        # grid specs are calibrated from a reference geometry representative
        # of the traffic; pass (verts, faces) to match your fleet
        self._reference = reference if reference is not None else \
            geo.car_surface(geo.sample_params(0))
        if _restore:
            # deploy-artifact state (from_artifact): learned ladder and
            # request-size histogram, calibrated specs
            self._calib.update(_restore.get("calib", {}))
            # only specs matching THIS server's shard topology are usable;
            # a changed shard_devices/n_mp_layers recalibrates on demand
            self._shard_calib.update(
                {n: s for n, s in _restore.get("shard_calib", {}).items()
                 if s.n_shards == self.shard_devices
                 and s.halo_hops == cfg.n_mp_layers})
            self._ladder |= set(_restore.get("ladder", ()))
            for s in _restore.get("size_hist", ()):
                self._size_hist.append(int(s))
        for n in seed_sizes:
            self._buckets[n] = self._build_bucket(n)
            self._queues[n] = deque()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: GNNConfig,
                        bucket_sizes: Union[str, Sequence[int]] = (1024,),
                        **kw):
        """Serve trained weights: params and normalizer stats from a
        ``launch.train`` checkpoint of either package. ``bucket_sizes``
        accepts ``"auto"`` like the constructor."""
        model, norm_in, norm_out = load_gnn_checkpoint(
            path, cfg, device=resolve(kw.get("device")))
        return cls(cfg, bucket_sizes, params=model, norm_in=norm_in,
                   norm_out=norm_out, **kw)

    # ------------------------------------------------------ deploy artifacts

    # server-construction knobs carried inside the artifact so from_artifact
    # rebuilds an identical server (the JAX server's)
    _ARTIFACT_KNOBS = ("max_batch", "n_levels", "seed", "check_requests",
                       "reject_overflow", "async_flush", "shard_devices",
                       "shard_pad_factor")
    # knobs of the JAX server that a JAX artifact carries: read and ignored
    _JAX_ONLY_KNOBS = ("knn_impl", "interpret", "donate")

    def save_artifact(self, path: str) -> dict:
        """Freeze this server's learned state into one deploy artifact.

        The artifact bundles the params (the JAX tree layout) and
        normalizers, the config and knobs, the autoscaler's ladder and
        request-size histogram, the reference geometry and every calibrated
        grid spec (and ``ShardSpec``): everything :meth:`from_artifact`
        needs to serve with no calibration. Every ladder target is
        calibrated first. ``aot`` is empty: the port compiles no program.
        Returns a summary dict (path, live buckets, ladder, aot buckets).
        """
        with self._cond:
            live = sorted(self._buckets)
            ladder = sorted(set(self._buckets) | self._ladder)
            size_hist = [int(s) for s in self._size_hist]
        for n in ladder:
            ms = self._calibrate(n)
            if self.shard_devices > 1:
                self._calibrate_shard(n, ms)

        def norm_tree(nm):
            if nm is None:
                return None
            mean, std = nm
            return {"mean": np.asarray(mean, np.float32),
                    "std": np.asarray(std, np.float32)}

        ref_verts, ref_faces = self._reference
        tree = {
            "params": params_to_jax(self.params),
            "norm_in": norm_tree(self._norm_in),
            "norm_out": norm_tree(self._norm_out),
            "cfg": dataclasses.asdict(self.cfg),
            "knobs": {k: getattr(self, k) for k in self._ARTIFACT_KNOBS},
            # the JAX server's compile knobs at its defaults, which its
            # from_artifact reads, so it rebuilds its default server
            "knn_impl": "xla", "interpret": True, "donate": True,
            "auto": bool(self.auto),
            "reference": {"verts": np.asarray(ref_verts, np.float32),
                          "faces": np.asarray(ref_faces)},
            "ladder": [int(n) for n in ladder],
            "live": [int(n) for n in live],
            "size_hist": size_hist,
            "calib": {str(n): artifact_lib.pack_multiscale_spec(ms)
                      for n, ms in self._calib.items()},
            "shard_calib": {str(n): artifact_lib.pack_shard_spec(s)
                            for n, s in self._shard_calib.items()},
            "aot": {},
        }
        artifact_lib.save_artifact(path, tree, backend=self.device.type)
        return {"path": path, "buckets": live, "ladder": ladder,
                "aot_buckets": []}

    @classmethod
    def from_artifact(cls, path: str, cfg: Optional[GNNConfig] = None,
                      **kw) -> "GNNServer":
        """Restore a server from a deploy artifact of either package.

        Rebuilds the saved server (params, normalizers, knobs, adapted
        ladder, request-size histogram, calibrated grid specs) on
        ``device`` (default: the card); its buckets never calibrate, nor
        does a later evict->rebuild. ``cfg`` (default: the artifact's) and
        keyword knobs override the saved ones (``n_levels`` and
        ``check_requests`` among them). Of the JAX server's knobs,
        ``knn_impl``, ``interpret`` and ``donate`` are read and ignored, as
        are a JAX artifact's AOT executables.
        """
        tree = artifact_lib.load_artifact(path)
        if cfg is None:
            known = {f.name for f in dataclasses.fields(GNNConfig)}
            stored = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in tree.get("cfg", {}).items() if k in known}
            cfg = GNNConfig(**stored)
        if tree.get("auto"):
            cfg = cfg.replace(bucket_policy="auto")
        knobs = dict(tree.get("knobs", {}))
        knobs.update(kw)
        for k in cls._JAX_ONLY_KNOBS:
            knobs.pop(k, None)
        device = resolve(knobs.pop("device", None))

        def norm_pair(d):
            if d is None:
                return None
            return (np.asarray(d["mean"], np.float32),
                    np.asarray(d["std"], np.float32))

        ref = tree["reference"]
        restore = {
            "calib": {int(n): artifact_lib.unpack_multiscale_spec(d)
                      for n, d in tree.get("calib", {}).items()},
            "shard_calib": {int(n): artifact_lib.unpack_shard_spec(d)
                            for n, d in tree.get("shard_calib", {}).items()},
            "ladder": [int(n) for n in tree.get("ladder", ())],
            "size_hist": [int(s) for s in tree.get("size_hist", ())],
        }
        live = [int(n) for n in tree.get("live", ())]
        return cls(cfg, tuple(live) if live else "auto",
                   params=params_from_jax(tree["params"], cfg, device=device),
                   norm_in=norm_pair(tree.get("norm_in")),
                   norm_out=norm_pair(tree.get("norm_out")),
                   reference=(np.asarray(ref["verts"], np.float32),
                              np.asarray(ref["faces"])),
                   device=device, _restore=restore, **knobs)

    # ------------------------------------------------------------- buckets

    def _sample_reference(self, n: int):
        """Deterministic n-point sample of the calibration reference."""
        verts, faces = self._reference
        return sample_surface(verts, faces, n, np.random.default_rng(0))

    def _calibrate(self, n: int) -> MultiscaleSpec:
        """Grid calibration for one bucket size, cached per size: the entry
        outlives the bucket, so ``stats.bucket_calibrations`` counts the
        calibrations actually run (an evict->rebuild adds none)."""
        ms = self._calib.get(n)
        if ms is not None:
            return ms
        faults.fire("bucket.calibrate")
        levels = _level_sizes(n, self.n_levels)
        ref_pts, _ = self._sample_reference(n)
        k = self.cfg.k_neighbors
        grids = tuple(hashgrid.calibrate_spec(ref_pts[:m], k, n_points=m)
                      for m in levels)
        ms = MultiscaleSpec(level_sizes=levels, k=k, grids=grids)
        self._calib[n] = ms
        with self.stats.lock:
            self.stats.bucket_calibrations += 1
        return ms

    def _calibrate_shard(self, n: int, ms: MultiscaleSpec
                         ) -> sharded.ShardSpec:
        """The ``ShardSpec`` of one bucket size, cached per size: per-shard
        level capacities, merged shard-local grids and the geometric halo
        width are functions of ``(bucket size, shard_devices, n_mp_layers,
        shard_pad_factor)`` and the reference, so an evict->rebuild gets the
        same signature without planning the reference again."""
        sspec = self._shard_calib.get(n)
        if sspec is not None:
            return sspec
        faults.fire("bucket.calibrate")
        cfg = self.cfg
        ref_pts, ref_nrm = self._sample_reference(n)
        sspec = sharded.shard_spec_for(
            n, self.shard_devices, cfg.n_mp_layers, self.shard_pad_factor,
            reference_points=ref_pts, reference_normals=ref_nrm,
            level_sizes=ms.level_sizes, k=cfg.k_neighbors, ms=ms)
        self._shard_calib[n] = sspec
        with self.stats.lock:
            self.stats.bucket_calibrations += 1
        return sspec

    def _build_bucket(self, n: int) -> Bucket:
        """Calibrate (cached per size) and wire one padding bucket. Nothing
        is compiled or allocated on the card here."""
        faults.fire("bucket.build")
        ms = self._calibrate(n)
        if self.shard_devices > 1:
            # per-shard shapes and grids are a function of the bucket size;
            # each request is then planned against them with host numpy
            sspec = self._calibrate_shard(n, ms)
            infer = sharded.make_sharded_infer_fn(
                self.cfg, sspec, norm_in=self._norm_in,
                norm_out=self._norm_out, pack_width=self.max_batch,
                device=self.device)
            return Bucket(n_points=n, ms=ms, infer=infer, sspec=sspec,
                          plan_sig=sspec.signature())
        edges: List[List[int]] = []
        infer = make_batched_infer_fn(self.cfg, ms, norm_in=self._norm_in,
                                      norm_out=self._norm_out,
                                      on_edges=edges.append)
        return Bucket(n_points=n, ms=ms, infer=infer, edges=edges)

    def _round_up(self, n: int) -> int:
        g = max(int(self.cfg.bucket_granularity), 1)
        return ((max(int(n), 1) + g - 1) // g) * g

    def ladder(self) -> Tuple[int, ...]:
        """Live bucket sizes."""
        with self._cond:
            return tuple(sorted(self._buckets))

    def target_ladder(self) -> Tuple[int, ...]:
        """Every size requests can route to: live buckets + refit targets."""
        with self._cond:
            return tuple(sorted(set(self._buckets) | self._ladder))

    def bucket_for(self, n_points: Optional[int]) -> int:
        """Pure routing query: which ladder size would serve ``n_points``?
        No side effects (``submit`` routes through :meth:`_route`)."""
        return self._route(n_points, mutate=False)

    def _route(self, n_points: Optional[int], mutate: bool) -> int:
        """Route a requested resolution to a ladder size.

        Static ladder: smallest bucket that fits; an oversize ask warns
        (once per ladder max), counts ``stats.oversize_requests`` and returns
        the largest bucket. Auto: an oversize ask grows the ladder by
        ``_round_up(n_points)``. ``mutate=False`` answers without growing,
        warning or counting.
        """
        with self._cond:
            sizes = sorted((set(self._buckets) | self._ladder)
                           - self._quarantined)
            if not sizes and not self.auto:
                raise RuntimeError(
                    "no live bucket can serve: every ladder size is "
                    f"quarantined ({sorted(self._quarantined)}) after "
                    "build/call failures")
            if n_points is None:
                if sizes:
                    return sizes[-1]
                n_points = 1024               # auto + empty ladder: bootstrap
            for s in sizes:
                if n_points <= s:
                    return s
            if self.auto:
                # check-and-grow atomically so concurrent submits of the
                # same oversize ask add (and count) the new size once
                s = self._round_up(n_points)
                if mutate and s not in self._ladder:
                    self._ladder.add(s)
                    with self.stats.lock:
                        self.stats.grown_buckets += 1
                return s
        if not mutate:
            return sizes[-1]
        with self.stats.lock:
            self.stats.oversize_requests += 1
        if self.reject_overflow:
            msg = (f"request for {n_points} points exceeds the largest "
                   f"bucket ({sizes[-1]}) and will be REJECTED "
                   "(reject_overflow is set); use bucket_sizes='auto' to "
                   "grow the ladder instead")
            if self._warn_once(("oversize_reject", sizes[-1]), msg):
                warnings.warn(msg)
        else:
            msg = (f"request for {n_points} points exceeds the largest "
                   f"bucket ({sizes[-1]}): serving a DOWNSAMPLED "
                   f"{sizes[-1]}-point cloud. Pass reject_overflow=True to "
                   "reject oversize requests, or bucket_sizes='auto' to "
                   "let the ladder grow instead")
            if self._warn_once(("oversize_downsample", sizes[-1]), msg):
                warnings.warn(msg)
        return sizes[-1]

    def _refit_ladder_locked(self):
        """Quantile refit (holding ``_cond``): retarget the ladder to the
        observed size distribution, keeping the current max for coverage."""
        if not self._size_hist:
            return
        hist = np.asarray(self._size_hist)
        targets = {self._round_up(int(np.quantile(hist, q)))
                   for q in self.cfg.bucket_quantiles}
        if self._ladder:
            targets.add(max(self._ladder))    # never shrink oversize coverage
        targets -= self._quarantined          # never re-target a failed size
        cap = max(int(self.cfg.max_live_buckets), 1)
        self._ladder = set(sorted(targets)[-cap:])

    def _ensure_bucket(self, n: int) -> Bucket:
        """Bucket cache lookup: a hit bumps LRU recency; a miss builds the
        bucket and, in auto mode, evicts the least-recently-used idle bucket
        beyond ``cfg.max_live_buckets``. "Idle" means no queued requests and
        not part of the drain plan being executed (the cap is soft within a
        plan). A bucket holds host objects only, so eviction frees no device
        memory; the policy and counters are kept so that traffic gives the
        JAX server's ladder. Sharded servers key the cache by ``(size,
        plan signature)``: a live bucket built for another ``ShardSpec``
        than the size's cached one is a miss, rebuilt against the current
        spec."""
        with self._cond:
            b = self._buckets.get(n)
            if b is not None and self.shard_devices > 1:
                sc = self._shard_calib.get(n)
                if sc is not None and b.plan_sig != sc.signature():
                    del self._buckets[n]      # stale shard plan: rebuild
                    b = None
            if b is not None:
                self._tick += 1
                b.last_used = self._tick
                with self.stats.lock:
                    self.stats.bucket_hits += 1
                return b
        with self.stats.lock:
            self.stats.bucket_misses += 1
        b = self._build_bucket(n)             # slow host work: outside _cond
        with self._cond:
            self._tick += 1
            b.last_used = self._tick
            self._buckets[n] = b
            self._queues.setdefault(n, deque())
            if self.auto:
                cap = max(int(self.cfg.max_live_buckets), 1)
                while len(self._buckets) > cap:
                    idle = [s for s in self._buckets
                            if s != n and not self._queues.get(s)
                            and s not in self._plan_sizes]
                    if not idle:
                        break                 # everything else has traffic
                    victim = min(idle,
                                 key=lambda s: self._buckets[s].last_used)
                    del self._buckets[victim]
                    self._queues.pop(victim, None)
                    with self.stats.lock:
                        self.stats.bucket_evictions += 1
        return b

    # ------------------------------------------- quarantine / degradation

    def _quarantine(self, n: int, err: Exception):
        """Pull a failed size out of service: drop its bucket + ladder
        entry so no future request routes to it; traffic falls back to the
        next-larger live size (see ``_dispatch_item``). Warn-once."""
        with self._cond:
            if n in self._quarantined:
                return
            self._quarantined.add(n)
            self._buckets.pop(n, None)
            self._ladder.discard(n)
        self.stats.bump("quarantined_buckets")
        msg = (f"bucket {n} quarantined after a build/call failure "
               f"({type(err).__name__}: {err}); traffic falls back to the "
               "next-larger live bucket")
        if self._warn_once(("quarantine", n), msg):
            warnings.warn(msg)

    def _next_size_above(self, size: int) -> Optional[int]:
        """Smallest non-quarantined routable size strictly above ``size``."""
        with self._cond:
            cands = sorted(s for s in set(self._buckets) | self._ladder
                           if s > size and s not in self._quarantined)
        return cands[0] if cands else None

    def _dispatch_item(self, n: int, batch: List[Request],
                       record: bool = True, land=None) -> _InFlight:
        """prepare+dispatch one work item, degrading past failed buckets.

        ``land`` (the async flush) is called once, after the first prepare
        and before the dispatch: it harvests the batch still on the card.

        A bucket whose build raises, or whose call raises synchronously (an
        out-of-memory error, a kernel wrapper's error, a failed kernel
        build at first use), is quarantined and the batch retries on the
        next-larger live size (``stats.bucket_fallbacks``); only when no
        larger size exists does the failure propagate. Host prepare errors
        (bad geometry) propagate at once: they are the request's fault.
        """
        size: Optional[int] = n
        last_err: Optional[Exception] = None
        while size is not None:
            try:
                b = self._ensure_bucket(size)
            except Exception as e:
                last_err = e
                self._quarantine(size, e)
                size = self._next_size_above(size)
                continue
            if size != n:
                with self._cond:       # shield the fallback bucket from LRU
                    self._plan_sizes.add(size)
            pre, ok, samples, t0 = self._prepare(b, batch, record)
            if land is not None:
                land()
                land = None
            try:
                fl = self._dispatch(b, pre, ok, samples, record)
            except Exception as e:
                last_err = e
                self._quarantine(size, e)
                size = self._next_size_above(size)
                continue
            fl.t_start = t0
            if size != n and record:
                self.stats.bump("bucket_fallbacks")
            return fl
        raise last_err if last_err is not None else RuntimeError(
            f"no live bucket can serve size {n}")

    def _empty_result(self, rid: int, bucket: int, latency_s: float,
                      error: str) -> Result:
        return Result(request_id=rid, points=np.zeros((0, 3), np.float32),
                      fields=np.zeros((0, self.cfg.node_out), np.float32),
                      latency_s=latency_s, bucket=bucket, batch_size=0,
                      error=error)

    def _timeout_result(self, n: int, req: Request) -> Result:
        """Resolve one deadline-expired request (never reached the device)."""
        self.stats.bump("timed_out_requests")
        t = time.perf_counter()
        waited = t - (req.t_submit or t)
        return self._empty_result(
            req.request_id, n, waited,
            f"deadline exceeded: request waited {waited * 1e3:.1f} ms, "
            "dropped before device work")

    def _resolve_error_locked(self, bucket: int, reason: str) -> int:
        """Allocate a rid and resolve it immediately as an error Result
        (shed/dead-server submits). Caller holds ``_cond``."""
        rid = self._next_id
        self._next_id += 1
        self._done[rid] = self._empty_result(rid, bucket, 0.0, reason)
        self._cond.notify_all()
        return rid

    # ------------------------------------------------------------- serving

    def submit(self, verts: np.ndarray, faces: np.ndarray,
               n_points: Optional[int] = None, *,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue a geometry; returns the request id. Thread-safe; wakes
        the background worker (if running).

        ``timeout_s`` (default ``request_timeout_s``; 0/None = no deadline)
        bounds how long the request may wait before device work starts; an
        expired request is resolved as a timed-out ``Result.error``.
        Bounded admission (``max_queue_depth > 0``): beyond the bound,
        ``shed_policy="reject"`` resolves the submit at once as an error
        (``stats.rejected_overload``) and ``"block"`` waits for queue space.
        A dead server resolves submits at once too, so a ``result()``
        waiter never hangs on a request that can no longer be served.
        """
        t0 = clock_ns()
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces)
        if timeout_s is None:
            timeout_s = self.request_timeout_s or None
        t_route = clock_ns()
        bucket = self._route(n_points, mutate=True)   # auto mode may grow
        t_routed = clock_ns()
        with self._cond:
            if self._worker_dead:
                return self._resolve_error_locked(
                    bucket, "server worker is dead (crashed beyond its "
                    "restart budget); restart the server")
            if self.max_queue_depth > 0:
                depth = sum(len(q) for q in self._queues.values())
                if depth >= self.max_queue_depth:
                    if self.shed_policy == "reject":
                        self.stats.bump("rejected_overload")
                        return self._resolve_error_locked(
                            bucket, f"rejected: queue full "
                            f"(max_queue_depth={self.max_queue_depth}, "
                            "shed_policy='reject')")
                    # "block": backpressure the producer until the worker
                    # drains (or the server stops/dies)
                    while True:
                        depth = sum(len(q) for q in self._queues.values())
                        if (depth < self.max_queue_depth
                                or self._worker is None):
                            break
                        if self._worker_dead:
                            return self._resolve_error_locked(
                                bucket, "server worker died while this "
                                "submit was blocked on queue space")
                        self._cond.wait(timeout=0.05)
            rid = self._next_id
            self._next_id += 1
            now = time.perf_counter()
            self._queues.setdefault(bucket, deque()).append(
                Request(verts=verts, faces=faces, request_id=rid,
                        n_points=n_points, t_submit=now,
                        deadline=None if not timeout_s
                        else now + float(timeout_s),
                        t_submit_ns=clock_ns()))
            self.stats.g_queue_depth.set(
                sum(len(q) for q in self._queues.values()))
            if self.auto:
                self._size_hist.append(bucket if n_points is None
                                       else int(n_points))
                self._refit_count += 1
                if self._refit_count >= max(int(self.cfg.bucket_refit_every),
                                            1):
                    self._refit_count = 0
                    self._refit_ladder_locked()
            self._cond.notify_all()
        tracer = self.telemetry.tracer
        tracer.record_span("submit", t0, clock_ns(), trace_id=f"req-{rid}",
                           bucket=bucket, n_points=n_points)
        tracer.record_span("bucket_route", t_route, t_routed,
                           trace_id=f"req-{rid}", bucket=bucket)
        return rid

    def pending(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def warmup(self):
        """Run each live bucket once on ``max_batch`` copies of the
        reference geometry (not recorded in the stats): the kernels are
        built and the card's allocator warmed before the first request.
        A warmup rejection is raised, not skipped."""
        verts, faces = self._reference
        with self._serve_lock:
            with self._cond:
                buckets = [self._buckets[n] for n in sorted(self._buckets)]
            for b in buckets:
                batch = [Request(verts, faces, -1, b.n_points)] * \
                    self.max_batch
                results = self._run_batch(b, batch, record=False)
                errs = [r.error for r in results if r.error is not None]
                if errs:
                    raise RuntimeError(
                        f"warmup failed for bucket {b.n_points}: {errs[0]}")

    def _sample(self, req: Request, n: int):
        # deterministic per (server seed, request id): independent of what
        # other traffic or warmup ran before this request
        rng = np.random.default_rng((self.seed, req.request_id + 1))
        return sample_surface(req.verts, req.faces, n, rng)

    def _check_cloud(self, b: Bucket, pts: np.ndarray, rid: int) -> int:
        """Numpy guard against clouds denser than the calibration reference,
        which would overflow a grid's candidate capacity and silently drop
        kNN candidates. Warns once per bucket."""
        dropped = sum(hashgrid.overflow_count(pts[:m], m, g)
                      for m, g in zip(b.ms.level_sizes, b.ms.grids))
        if dropped:
            with self.stats.lock:
                self.stats.overflow_requests += 1
            msg = (f"request {rid}: geometry overflows bucket "
                   f"{b.n_points}'s calibrated grid ({dropped} candidate "
                   "slots dropped); neighbor sets may be approximate; "
                   "recalibrate the server with a representative reference "
                   "geometry")
            if self._warn_once(("grid_overflow", b.n_points), msg):
                warnings.warn(msg)
        return dropped

    def _reject(self, req: Request, n_points: int, reason: str,
                pts: np.ndarray, record: bool) -> Result:
        if record:
            with self.stats.lock:
                self.stats.rejected_requests += 1
        nan = np.full((n_points, self.cfg.node_out), np.nan, np.float32)
        t = time.perf_counter()
        return Result(request_id=req.request_id, points=pts, fields=nan,
                      latency_s=t - (req.t_submit or t), bucket=n_points,
                      batch_size=0, error=reason)

    def _nonfinite_result(self, b: Bucket, req: Request,
                          vals: np.ndarray) -> Result:
        """Resolve one request whose harvested output carried NaN/Inf."""
        self.stats.bump("nonfinite_results")
        total = int(np.size(vals))
        bad = total - int(np.isfinite(vals).sum())
        msg = (f"nonfinite output detected at harvest: {bad} of {total} "
               f"values are NaN/Inf (bucket {b.n_points})")
        if self._warn_once(("nonfinite", b.n_points), msg):
            warnings.warn(msg)
        nan = np.full((b.n_points, self.cfg.node_out), np.nan, np.float32)
        t = time.perf_counter()
        return Result(request_id=req.request_id,
                      points=np.zeros((0, 3), np.float32), fields=nan,
                      latency_s=t - (req.t_submit or t), bucket=b.n_points,
                      batch_size=0, error=msg)

    # ------------------------------------------- prepare / dispatch / harvest

    def _prepare(self, b: Bucket, reqs: List[Request], record: bool):
        """Host stage: sample surfaces + run the overflow checks; resolve
        rejections. Pure numpy: under the async flush it overlaps the
        previous batch's work on the card. Returns ``(rejections, ok
        requests, samples, start time)``."""
        with self.telemetry.span("prepare", bucket=b.n_points,
                                 batch=len(reqs)) as sp:
            t0 = time.perf_counter()
            results, ok_reqs, samples = self._prepare_reqs(b, reqs, record)
            t1 = time.perf_counter()
            sp.set(ok=len(ok_reqs))
        if record:
            self.stats.record_stage("prepare", t1 - t0)
        return results, ok_reqs, samples, t0

    def _prepare_reqs(self, b: Bucket, reqs: List[Request], record: bool):
        """``_prepare``'s work, a request at a time: ``(rejections, ok
        requests, samples)``."""
        tel = self.telemetry
        results: List[Result] = []
        ok_reqs, samples = [], []
        for req in reqs:
            if (self.reject_overflow and req.n_points is not None
                    and req.n_points > b.n_points):
                # static-ladder oversize: reject instead of downsampling
                results.append(self._reject(
                    req, b.n_points,
                    f"request for {req.n_points} points exceeds the "
                    f"largest bucket ({b.n_points}) and reject_overflow "
                    "is set; use bucket_sizes='auto' to grow the ladder",
                    np.zeros((0, 3), np.float32), record))
                continue
            with tel.span("sample", rid=req.request_id):
                pts, nrm = self._sample(req, b.n_points)
            dropped = 0
            if record and self.check_requests:
                with tel.span("check_cloud", rid=req.request_id):
                    dropped = self._check_cloud(b, pts, req.request_id)
            if dropped and self.reject_overflow:
                results.append(self._reject(
                    req, b.n_points,
                    f"grid overflow: {dropped} candidate slots "
                    "dropped (geometry denser than calibration reference)",
                    pts, record))
                continue
            ok_reqs.append(req)
            samples.append((pts, nrm))
        return results, ok_reqs, samples

    def _dispatch(self, b: Bucket, pre: List[Result], ok_reqs: List[Request],
                  samples, record: bool) -> _InFlight:
        """Device stage: copy in, enqueue the bucket's pipeline, copy out;
        no waiting on the card."""
        with self.telemetry.span("dispatch", bucket=b.n_points,
                                 batch=len(ok_reqs)):
            t0 = time.perf_counter()
            fl = self._dispatch_inner(b, pre, ok_reqs, samples, record)
            t1 = time.perf_counter()
        if record and ok_reqs:
            self.stats.record_stage("dispatch", t1 - t0)
        return fl

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # a copy from pageable memory would synchronise the stream (wait
            # for the batch still on the card); the pinned block goes back
            # to PyTorch's host cache, which reuses it only once the copy
            # has completed
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _dispatch_inner(self, b: Bucket, pre: List[Result],
                        ok_reqs: List[Request], samples,
                        record: bool) -> _InFlight:
        if not ok_reqs:
            return _InFlight(bucket=b, results=pre, ok_reqs=[], host=None,
                             pts=np.zeros((0,)), record=record)
        faults.fire("serve.dispatch")
        pack = None
        if b.sspec is not None:
            pre, ok_reqs, samples, pack = self._plan_shards(
                b, pre, ok_reqs, samples, record)
            if pack is None:
                return _InFlight(bucket=b, results=pre, ok_reqs=[],
                                 host=None, pts=np.zeros((0,)),
                                 record=record)
        n = b.n_points
        on_card = self.device.type == "cuda"
        start = event = None
        with self.telemetry.span("h2d"):
            # only the real requests run: no replay rows (module docstring)
            pts = np.stack([p for p, _ in samples])
            nrm = np.stack([m for _, m in samples])
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            if pack is None:
                args = (self._to_device(pts), self._to_device(nrm),
                        [n] * len(ok_reqs))
            else:
                args = (pack.batch(self.device),)
        b.edges.clear()
        out = self._call_bucket(b, *args)
        edges = b.edges.pop() if b.edges else None
        host = out
        if on_card:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return _InFlight(bucket=b, results=pre, ok_reqs=ok_reqs, host=host,
                         pts=pts, record=record, event=event,
                         start_event=start,
                         t_dispatched=time.perf_counter(), plan=pack,
                         edges=edges)

    def _plan_shards(self, b: Bucket, pre: List[Result],
                     ok_reqs: List[Request], samples, record: bool):
        """Sharded mode: plan each geometry against the bucket's frozen
        ``ShardSpec`` (``geometric``, host numpy). A failed plan (shards that
        outgrow the spec, or an injected ``shard.plan`` fault) is the
        request's fault: it is rejected and the others go on; the bucket is
        never quarantined for it. Returns ``(rejections, kept requests,
        their samples, PackPlan or None)``."""
        kept, kept_samples, plans = [], [], []
        for (pts, nrm), req in zip(samples, ok_reqs):
            try:
                faults.fire("shard.plan")
                # the dilation is the halo width frozen into the spec
                plan = sharded.plan_shards(
                    pts, nrm, self.shard_devices, self.cfg.n_mp_layers,
                    b.ms.level_sizes, self.cfg.k_neighbors,
                    method="geometric", spec=b.sspec)
            except Exception as e:
                pre = pre + [self._reject(req, b.n_points,
                                          str(e) or repr(e), pts, record)]
                continue
            kept.append(req)
            kept_samples.append((pts, nrm))
            plans.append(plan)
        pack = sharded.pack_plans(plans, self.max_batch) if plans else None
        return pre, kept, kept_samples, pack

    def _call_bucket(self, b: Bucket, *args):
        """The bucket's pipeline on the card. What it raises synchronously
        (out of memory, a wrapper's check, a kernel that fails to build at
        first use) quarantines the bucket in ``_dispatch_item``; a fault in
        a kernel surfaces at the harvest instead."""
        faults.fire("serve.compile")      # chaos: failure at the bucket call
        ev = None if b.called else compile_cache.CompileEvents()
        t0 = time.perf_counter()
        t0_ns = clock_ns()
        with self.telemetry.span("enqueue", bucket=b.n_points):
            out = b.infer(self.params, *args)
        if ev is not None:
            # a bucket's first call builds (nvcc) or loads the kernels this
            # process has not loaded yet, synchronously, before it enqueues
            b.called = True
            compiles, loads = ev.delta()
            if compiles or loads:
                t1 = time.perf_counter()
                with self.stats.lock:
                    self.stats.bucket_compiles += compiles
                    self.stats.cache_loads += loads
                stage = "compile" if compiles else "cache_load"
                self.stats.record_stage(stage, t1 - t0)
                self.telemetry.tracer.record_span(
                    stage, t0_ns, clock_ns(), bucket=b.n_points,
                    compiles=compiles, cache_loads=loads)
        return out

    def _padding_of(self, b: Bucket, req: Request) -> Tuple[int, int]:
        """(requested, padded-waste) point counts for one served request."""
        asked = b.n_points if req.n_points is None else \
            min(int(req.n_points), b.n_points)
        return asked, b.n_points - asked

    def _harvest(self, fl: _InFlight) -> List[Result]:
        """Sync stage: wait on the batch's event, build Results, record.

        The wait is the ``device_wait`` stage (how long the host stalled on
        the card); the copy into a numpy array, the nonfinite guard and
        the bookkeeping after it are ``harvest``. ``Result.run_s`` is the
        batch's run: on the card, the time between CUDA events before its
        input copy and after its output copy (the batch alone, whatever
        was queued before it); on the CPU, the host's prepare and compute.
        """
        results = list(fl.results)
        if fl.host is None:
            return results
        b, record = fl.bucket, fl.record
        tel = self.telemetry
        with tel.span("device_wait", bucket=b.n_points,
                      batch=len(fl.ok_reqs)):
            t0 = time.perf_counter()
            if fl.event is not None:
                fl.event.synchronize()
            t_sync = time.perf_counter()
        if record:
            self.stats.record_stage("device_wait", t_sync - t0)
        with tel.span("harvest", bucket=b.n_points, batch=len(fl.ok_reqs)):
            out = fl.host.numpy().copy()
            out = faults.corrupt("serve.harvest", out)   # chaos: garbage
            if fl.plan is not None:
                # sharded: the owned rows of each geometry gathered back
                # into one cloud; the guard below then runs per geometry
                out = fl.plan.gather(out)
            guard = self.cfg.nonfinite_guard
            t_done = time.perf_counter()
            t_done_ns = clock_ns()
            run_s = (fl.start_event.elapsed_time(fl.event) / 1e3
                     if fl.event is not None
                     else fl.t_dispatched - fl.t_start)
            lats = []
            for i, req in enumerate(fl.ok_reqs):
                if guard and not np.isfinite(out[i]).all():
                    # nonfinite garbage never reaches a client as data; the
                    # per-item scan contains it to this request
                    results.append(self._nonfinite_result(b, req, out[i]))
                    continue
                lat = t_done - (req.t_submit or t_done)
                lats.append(lat)
                results.append(Result(
                    request_id=req.request_id, points=fl.pts[i],
                    fields=out[i], latency_s=lat, bucket=b.n_points,
                    batch_size=len(fl.ok_reqs), run_s=run_s))
                tel.tracer.record_span(
                    "request", req.t_submit_ns or t_done_ns, t_done_ns,
                    trace_id=f"req-{req.request_id}", bucket=b.n_points)
        if record and fl.ok_reqs:
            padding = [self._padding_of(b, req) for req in fl.ok_reqs]
            for lat in lats:
                self.stats.record_request(b.n_points, lat, run_s)
            self.stats.record_batch(len(fl.ok_reqs))
            self.stats.record_stage("harvest", t_done - t_sync)
            with self.stats.lock:
                self.stats.requested_points += sum(a for a, _ in padding)
                self.stats.padding_points += sum(w for _, w in padding)
                if fl.edges is not None:
                    self.stats.edges_computed += sum(fl.edges)
                    self.stats.edge_slots += len(fl.edges) * b.ms.n_edges
            b.served += len(fl.ok_reqs)
        return results

    def _run_batch(self, b: Bucket, reqs: List[Request],
                   record: bool = True) -> List[Result]:
        """Synchronous prepare -> dispatch -> harvest of one batch."""
        pre, ok_reqs, samples, t0 = self._prepare(b, reqs, record)
        fl = self._dispatch(b, pre, ok_reqs, samples, record)
        fl.t_start = t0
        return self._harvest(fl)

    # ------------------------------------------------------------- flushing

    def _drain_plan(self, ready_only: bool = False
                    ) -> Tuple[List[Tuple[int, List[Request]]],
                               List[Tuple[int, Request]]]:
        """Pop queued requests into (bucket size, batch) work items (caller
        holds ``_cond``).

        Deterministic order: ascending bucket size, FIFO within a bucket.
        ``ready_only`` keeps batches that are full or whose oldest request
        has waited the background deadline. Items carry the size, not the
        bucket: under the autoscaler it may not be built yet. Requests whose
        own deadline has expired are filtered out first and returned
        separately as ``(size, request)``: they never reach device work.
        """
        now = time.perf_counter()
        width = self.max_batch
        plan: List[Tuple[int, List[Request]]] = []
        timed_out: List[Tuple[int, Request]] = []
        for n in sorted(self._queues):
            q = self._queues[n]
            if any(r.deadline is not None and now >= r.deadline for r in q):
                fresh: deque = deque()
                while q:
                    r = q.popleft()
                    if r.deadline is not None and now >= r.deadline:
                        timed_out.append((n, r))
                    else:
                        fresh.append(r)
                q.extend(fresh)
            while q:
                due = now - q[0].t_submit >= self._deadline_s
                if ready_only and len(q) < width and not due:
                    break
                plan.append((n, [q.popleft()
                                 for _ in range(min(len(q), width))]))
        # queue wait ends when the request is popped into a work plan
        t_pop = time.perf_counter()
        t_pop_ns = clock_ns()
        tracer = self.telemetry.tracer
        for n, batch in plan:
            for req in batch:
                self.stats.record_stage("queue_wait", t_pop - req.t_submit)
                tracer.record_span("queue_wait", req.t_submit_ns, t_pop_ns,
                                   trace_id=f"req-{req.request_id}",
                                   bucket=n)
        return plan, timed_out

    def _item_error(self, n_points: int, batch: List[Request],
                    e: Exception) -> _InFlight:
        """Turn one failed work item into error Results (background mode)."""
        res = [self._reject(req, n_points, f"serving error: {e!r}",
                            np.zeros((0, 3), np.float32), True)
               for req in batch]
        return _InFlight(bucket=None, results=res, ok_reqs=[], host=None,
                         pts=np.zeros((0,)), record=True)

    def _run_plan(self, plan, async_mode: bool,
                  errors_as_results: bool = False) -> List[Result]:
        """Execute drained work items; async mode double-buffers.

        Async loop order per item j: prepare(j) [host, while batch j-1 runs
        on the card] -> harvest(j-1) [wait] -> dispatch(j) [enqueue]. The
        JAX server dispatches j before it harvests j-1; here a dispatch
        blocks once the card's launch queue is full, about one row of a
        bucket behind, so that order held j-1's results back until j had
        nearly run (measured in ``chip_smoke.py`` phase 12, ``PERF.md``),
        and this one loses only the host's few milliseconds between a
        harvest and the next enqueue. Batch j-1 is harvested even when
        preparing or dispatching j raises.
        ``errors_as_results`` (background worker): a failure is contained
        to its work item, whose requests come back as error Results;
        foreground flushes raise.
        """
        with self._serve_lock:
            with self._cond:                  # shield plan buckets from LRU
                self._plan_sizes = {n for n, _ in plan}
            try:
                with self.telemetry.span(
                        "flush", items=len(plan),
                        mode="async" if async_mode else "sync"):
                    return self._run_plan_body(plan, async_mode,
                                               errors_as_results)
            finally:
                with self._cond:
                    self._plan_sizes = set()

    def _run_plan_body(self, plan, async_mode: bool,
                       errors_as_results: bool) -> List[Result]:
        results: List[Result] = []
        t0 = time.perf_counter()
        if not async_mode:
            for n, batch in plan:
                try:
                    fl = self._dispatch_item(n, batch)
                    results.extend(self._harvest(fl))
                except Exception as e:
                    if not errors_as_results:
                        raise
                    results.extend(self._item_error(n, batch, e).results)
        else:
            inflight: Optional[_InFlight] = None

            def land():
                nonlocal inflight
                if inflight is not None:
                    fl, inflight = inflight, None
                    results.extend(self._harvest_guarded(
                        fl, errors_as_results))

            for n, batch in plan:
                try:
                    nxt = self._dispatch_item(n, batch, land=land)
                except Exception as e:
                    land()
                    if not errors_as_results:
                        raise
                    nxt = self._item_error(n, batch, e)
                inflight = nxt
            land()
        with self.stats.lock:
            self.stats.t_serving += time.perf_counter() - t0
        return results

    def _harvest_guarded(self, fl: _InFlight,
                         errors_as_results: bool) -> List[Result]:
        try:
            return self._harvest(fl)
        except Exception as e:
            if not errors_as_results:
                raise
            n = fl.bucket.n_points if fl.bucket is not None else 0
            return list(fl.results) + \
                self._item_error(n, fl.ok_reqs, e).results

    def flush(self, *, async_mode: Optional[bool] = None) -> List[Result]:
        """Drain every queue, up to ``max_batch`` requests per batch.

        ``async_mode`` overrides the server's ``async_flush`` default.
        Deadline-expired requests come back first as timed-out error
        Results, then served results in deterministic drain order. Raises
        while the background worker runs (it would steal the requests that
        ``result()`` waiters are blocked on).
        """
        self._assert_no_worker()
        with self._cond:
            plan, timed_out = self._drain_plan()
        expired = [self._timeout_result(n, req) for n, req in timed_out]
        return expired + self._run_plan(plan, self.async_flush
                                        if async_mode is None else async_mode)

    def _assert_no_worker(self):
        if self._worker is not None:
            raise RuntimeError(
                "flush()/serve() while the background worker is running "
                "would steal its queued requests; use submit()/result(), "
                "or stop() the worker first")

    def serve(self, requests: Sequence[Tuple[np.ndarray, np.ndarray,
                                             Optional[int]]]) -> List[Result]:
        """Submit + flush a stream of (verts, faces, n_points) requests.
        Guarded against a running worker before submitting; submits resolved
        without queueing (shed, dead server) are appended after the flush's
        results."""
        self._assert_no_worker()
        rids = [self.submit(verts, faces, n_points)
                for verts, faces, n_points in requests]
        results = self.flush()
        with self._cond:
            shed = [self._done.pop(rid) for rid in rids
                    if rid in self._done]
        return results + shed

    # ------------------------------------------------- background front-end

    def start(self, deadline_s: float = 0.02, result_cap: int = 4096):
        """Spawn the background flush worker (deadline-based microbatching).

        A bucket is flushed as soon as it holds ``max_batch`` requests or
        its oldest request is ``deadline_s`` old. Use ``submit`` + ``result``
        from any thread; ``stop()`` drains and joins. Finished results wait
        in a bounded buffer (``result_cap``), oldest uncollected evicted
        first.
        """
        if self._worker is not None:
            raise RuntimeError("background worker already running")
        self._deadline_s = float(deadline_s)
        self._done_cap = max(int(result_cap), 1)
        self._stop_flag = False
        self._worker_dead = False
        self._restarts = 0
        self.stats.g_worker_alive.set(1)
        self._worker = threading.Thread(target=self._worker_main, daemon=True,
                                        name="gnn-serve-worker")
        self._worker.start()

    def stop(self):
        """Stop the worker after draining everything still queued. Anything
        it could not drain is resolved as ``Result.error("server stopped
        ...")`` and waiters are woken: no ``result()`` waiter is stranded."""
        if self._worker is None:
            return
        with self._cond:
            self._stop_flag = True
            self._cond.notify_all()
        self._worker.join()
        self._worker = None
        self.stats.g_worker_alive.set(0)
        self._fail_pending("server stopped with this request unserved")

    def _fail_pending(self, reason: str):
        """Resolve every queued + in-flight request as an error Result and
        wake all waiters (worker crash / dead server / stop races)."""
        with self._cond:
            orphans = list(self._inflight)
            self._inflight = []
            for n in sorted(self._queues):
                q = self._queues[n]
                while q:
                    orphans.append(q.popleft())
            for req in orphans:
                self._done[req.request_id] = self._reject(
                    req, 0, reason, np.zeros((0, 3), np.float32), True)
            self.stats.g_queue_depth.set(0)
            if orphans:
                self._cond.notify_all()

    def health(self) -> dict:
        """Liveness/backlog snapshot for monitors (also exported as the
        ``serve_worker_alive`` / ``serve_queue_depth`` /
        ``serve_last_flush_timestamp`` gauges)."""
        with self._cond:
            depth = sum(len(q) for q in self._queues.values())
            inflight = len(self._inflight)
            worker = self._worker
            dead = self._worker_dead
            quarantined = sorted(self._quarantined)
        last_flush = self.stats.g_last_flush.value
        with self.stats.lock:
            errs = {name: getattr(self.stats, name)
                    for name in self.stats._RESILIENCE}
        return {
            "worker_alive": bool(worker is not None and worker.is_alive()
                                 and not dead),
            "worker_dead": dead,
            "queue_depth": depth,
            "inflight": inflight,
            "quarantined_buckets": quarantined,
            "last_flush_age_s": (time.time() - last_flush
                                 if last_flush else None),
            **errs,
        }

    def result(self, request_id: int, timeout: Optional[float] = None
               ) -> Result:
        """Block until the background worker finishes ``request_id``."""
        t0 = time.perf_counter()
        t0_ns = clock_ns()
        deadline = None if timeout is None else t0 + timeout
        with self._cond:
            self._waiting.add(request_id)     # shield from buffer eviction
            try:
                while request_id not in self._done:
                    rem = None if deadline is None else \
                        deadline - time.perf_counter()
                    if rem is not None and rem <= 0:
                        raise TimeoutError(f"request {request_id} not done "
                                           f"within {timeout}s")
                    self._cond.wait(timeout=rem)
                out = self._done.pop(request_id)
            finally:
                self._waiting.discard(request_id)
        self.telemetry.tracer.record_span("result", t0_ns, clock_ns(),
                                          trace_id=f"req-{request_id}")
        return out

    # ------------------------------------------------------------- rollouts

    def rollout_engine(self, **kw):
        """The server's transient-rollout engine (built on first use).

        One engine per server: it shares the bucket ladder, calibration
        cache, request-id space, device, telemetry registry and resilience
        knobs (see ``repro_torch.launch.rollout``). Keyword overrides
        (``slots``, ``steps_per_flush``) apply only on first construction.
        """
        if self._rollout is None:
            from repro_torch.launch.rollout import RolloutEngine
            self._rollout = RolloutEngine(self, **kw)
        return self._rollout

    def submit_rollout(self, verts: np.ndarray, faces: np.ndarray,
                       n_points: Optional[int] = None, *, steps: int = 1,
                       **kw) -> int:
        """Enqueue a T-step rollout; returns its id (see
        ``RolloutEngine.submit``). Collect with ``rollout_result``."""
        return self.rollout_engine().submit(verts, faces, n_points,
                                            steps=steps, **kw)

    def rollout_result(self, rollout_id: int):
        """Drive the engine until ``rollout_id`` resolves; returns its
        ``RolloutResult``."""
        return self.rollout_engine().result(rollout_id)

    def rollout(self, verts: np.ndarray, faces: np.ndarray,
                n_points: Optional[int] = None, *, steps: int = 1, **kw):
        """Submit one rollout and drive it to completion. Single-shot
        serving is exactly ``steps=1`` from a zero state (bit-equal under
        the default config)."""
        rid = self.submit_rollout(verts, faces, n_points, steps=steps, **kw)
        return self.rollout_result(rid)

    def _worker_main(self):
        """Worker supervisor: restart a crashed ``_serve_loop`` with capped
        exponential backoff; past the restart budget mark the server dead.
        Either way no waiter hangs: a crash resolves every queued and
        in-flight request as an error (``_fail_pending``) first, and a dead
        server resolves later submits at once."""
        backoff = max(float(self.cfg.worker_backoff_s), 1e-3)
        cap = max(float(self.cfg.worker_backoff_max_s), backoff)
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while True:
                try:
                    self._serve_loop()
                    return                     # graceful stop() drain
                except BaseException as e:
                    self.stats.bump("worker_crashes")
                    log.error("serve worker crashed: %r", e)
                    self._fail_pending(f"server worker crashed: {e!r}")
                    with self._cond:
                        if self._stop_flag:
                            return
                        self._restarts += 1
                        if self._restarts > self.worker_max_restarts:
                            self._worker_dead = True
                            self.stats.g_worker_alive.set(0)
                            self._cond.notify_all()
                            log.error(
                                "serve worker exceeded %d restarts; server "
                                "is dead until restarted",
                                self.worker_max_restarts)
                            return
                    self.stats.bump("worker_restarts")
                    log.warning("restarting serve worker (attempt %d/%d) "
                                "after %.2fs backoff", self._restarts,
                                self.worker_max_restarts, backoff)
                    time.sleep(backoff)
                    backoff = min(backoff * 2.0, cap)

    def _publish(self, results: List[Result]):
        """Land finished results in the buffer and wake waiters."""
        with self.telemetry.span("publish", results=len(results)), \
                self._cond:
            for r in results:
                self._done[r.request_id] = r
            self._inflight = []
            # evict oldest UNWAITED results beyond the cap — a result
            # someone is blocked on must survive until they collect it
            for rid in list(self._done):
                if len(self._done) <= self._done_cap:
                    break
                if rid not in self._waiting:
                    self._done.pop(rid)
            self.stats.g_queue_depth.set(
                sum(len(q) for q in self._queues.values()))
            self.stats.g_last_flush.set(time.time())
            self._cond.notify_all()

    def _serve_loop(self):
        while True:
            faults.fire("serve.worker")        # chaos: worker crash
            with self._cond:
                plan, expired = self._drain_plan(
                    ready_only=not self._stop_flag)
                if not plan and not expired:
                    if self._stop_flag:
                        return
                    # sleep until the oldest pending request would trip the
                    # flush deadline, or the earliest per-request deadline
                    # would expire (or a submit/stop notification)
                    now = time.perf_counter()
                    oldest = min((q[0].t_submit
                                  for q in self._queues.values() if q),
                                 default=None)
                    wakes = []
                    if oldest is not None:
                        wakes.append(self._deadline_s - (now - oldest))
                    wakes.extend(r.deadline - now
                                 for q in self._queues.values() for r in q
                                 if r.deadline is not None)
                    wait = max(min(wakes), 1e-4) if wakes else None
                    with self.telemetry.span("await_work"):
                        self._cond.wait(timeout=wait)
                    continue
                # until published, drained requests are "in flight": a
                # crash between drain and publish resolves them
                self._inflight = [req for _, batch in plan for req in batch]
            results = [self._timeout_result(n, req) for n, req in expired]
            try:
                results += self._run_plan(plan, self.async_flush,
                                          errors_as_results=True)
            except Exception as e:
                results += [self._reject(req, n, f"serving error: {e!r}",
                                         np.zeros((0, 3), np.float32), True)
                            for n, batch in plan for req in batch]
            self._publish(results)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--buckets", default="16384,65536",
                    help="comma-separated static ladder of point counts, or "
                    "'auto' to derive the ladder from traffic")
    ap.add_argument("--max-live-buckets", type=int, default=None,
                    help="bucket cache bound for --buckets auto (cold "
                    "buckets are LRU-evicted beyond it)")
    ap.add_argument("--bucket-granularity", type=int, default=None,
                    help="auto bucket sizes round up to this multiple")
    ap.add_argument("--refit-every", type=int, default=None,
                    help="submits between quantile ladder refits (auto)")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (hidden 64, 3 layers)")
    ap.add_argument("--sync", action="store_true",
                    help="disable the async double-buffered flush")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="serve the params and normalizers of this "
                    "launch.train checkpoint (either package's; its config "
                    "must match --reduced) instead of random weights")
    ap.add_argument("--compile-cache", default=None,
                    help="the CUDA kernels' build directory: a restarted "
                    "server loads the kernels built there instead of "
                    "running nvcc")
    ap.add_argument("--save-artifact", default=None,
                    help="after serving, freeze the adapted server (params, "
                    "ladder, histogram, calibrated specs) into this "
                    "deploy-artifact file")
    ap.add_argument("--artifact", default=None,
                    help="restore the server from a deploy artifact of "
                    "either package (GNNServer.from_artifact): no "
                    "calibration; its config replaces --reduced")
    ap.add_argument("--shard-devices", type=int, default=1,
                    help="serve each request in this many RCB shards with "
                    "halo rings, one after another on the device")
    ap.add_argument("--shard-pad-factor", type=float, default=None,
                    help="headroom of each bucket's shard shapes (default "
                    "cfg.shard_pad_factor)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the span tracer + profiler annotations")
    ap.add_argument("--trace-dir", default=None,
                    help="export trace.jsonl / trace_chrome.json / "
                    "metrics.prom / metrics.json here on exit "
                    "(implies --telemetry)")
    ap.add_argument("--profile", action="store_true",
                    help="additionally capture a torch.profiler trace "
                    "under <trace-dir>/torch_profile")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission control: bound the pending queue; "
                    "overflow is shed per --shed-policy (0 = unbounded)")
    ap.add_argument("--shed-policy", default=None,
                    choices=["reject", "block"],
                    help="what to do with submits past --max-queue-depth: "
                    "reject (immediate error Result) or block the producer")
    ap.add_argument("--request-timeout", type=float, default=None,
                    help="per-request deadline in seconds; requests that "
                    "wait longer are dropped before any device work and "
                    "resolve to an error Result (0 = no deadline)")
    ap.add_argument("--rollout-steps", type=int, default=0,
                    help="serve the demo traffic as T-step autoregressive "
                    "rollouts through the prefill/insert/generate engine "
                    "(0 = single-shot serving)")
    ap.add_argument("--rollout-slots", type=int, default=None,
                    help="concurrent rollouts per bucket slot table "
                    "(default cfg.rollout_slots)")
    ap.add_argument("--steps-per-flush", type=int, default=None,
                    help="physics steps per generate flush "
                    "(default cfg.rollout_steps_per_flush)")
    ap.add_argument("--state-feats", action="store_true",
                    help="feed the field state back into the node features "
                    "(rollout_state_feats; random weights are sized for it)")
    ap.add_argument("--integrator", default=None,
                    choices=["direct", "residual"],
                    help="rollout state integrator (default: the config's)")
    ap.add_argument("--rollout-timeout", type=float, default=None,
                    help="per-rollout end-to-end deadline in seconds "
                    "(0 = none)")
    args = ap.parse_args(argv)

    cfg = GNNConfig().reduced() if args.reduced else GNNConfig()
    if args.telemetry or args.trace_dir:
        cfg = cfg.replace(telemetry=True, trace_dir=args.trace_dir or "",
                          profile_capture=args.profile)
    if args.max_live_buckets is not None:
        cfg = cfg.replace(max_live_buckets=args.max_live_buckets)
    if args.bucket_granularity is not None:
        cfg = cfg.replace(bucket_granularity=args.bucket_granularity)
    if args.refit_every is not None:
        cfg = cfg.replace(bucket_refit_every=args.refit_every)
    if args.compile_cache:
        cfg = cfg.replace(compile_cache_dir=args.compile_cache)
    if args.max_queue_depth is not None:
        cfg = cfg.replace(max_queue_depth=args.max_queue_depth)
    if args.shed_policy is not None:
        cfg = cfg.replace(shed_policy=args.shed_policy)
    if args.request_timeout is not None:
        cfg = cfg.replace(request_timeout_s=args.request_timeout)
    if args.state_feats:
        cfg = cfg.replace(rollout_state_feats=True)
    if args.integrator is not None:
        cfg = cfg.replace(rollout_integrator=args.integrator)
    if args.rollout_slots is not None:
        cfg = cfg.replace(rollout_slots=args.rollout_slots)
    if args.steps_per_flush is not None:
        cfg = cfg.replace(rollout_steps_per_flush=args.steps_per_flush)
    if args.rollout_timeout is not None:
        cfg = cfg.replace(rollout_timeout_s=args.rollout_timeout)
    auto = args.buckets.strip().lower() == "auto"
    buckets = "auto" if auto else \
        tuple(int(b) for b in args.buckets.split(","))
    dev = resolve(args.device)
    kw = dict(max_batch=args.max_batch, seed=args.seed, device=dev,
              async_flush=not args.sync, shard_devices=args.shard_devices,
              shard_pad_factor=args.shard_pad_factor)
    if args.artifact:
        # the artifact carries its own config; apply the cache directory
        compile_cache.enable(args.compile_cache)
        t0 = time.perf_counter()
        server = GNNServer.from_artifact(args.artifact, device=dev,
                                         async_flush=not args.sync)
        auto = server.auto
        buckets = server.target_ladder() or buckets
        print(f"restored deploy artifact {args.artifact} in "
              f"{time.perf_counter() - t0:.2f}s: buckets "
              f"{list(server.ladder())}")
    elif args.ckpt:
        server = GNNServer.from_checkpoint(args.ckpt, cfg, buckets, **kw)
        print(f"loaded checkpoint {args.ckpt}")
    else:
        server = GNNServer(cfg, buckets, **kw)
    t0 = time.perf_counter()
    server.warmup()
    if auto:
        print("autoscaling buckets: ladder derived from traffic (nothing "
              "to warm up yet)")
    else:
        print(f"warmup ({len(buckets)} buckets): "
              f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(1)
    if auto:
        req_sizes = (128, 192, 256) if args.reduced else \
            (16384, 49152, 65536)
    else:
        req_sizes = buckets
    reqs = []
    for i in range(args.requests):
        verts, faces = geo.car_surface(geo.sample_params(i))
        reqs.append((verts, faces, int(rng.choice(req_sizes))))
    if args.rollout_steps > 0:
        _rollout_demo(server, reqs, args)
        _save_artifact(server, args.save_artifact)
        return
    with server.telemetry.capture():
        results = server.serve(reqs)
    rep = server.stats.report()
    errors = sum(r.error is not None for r in results)
    print(f"served {rep['requests']} requests on {dev} | "
          f"p50 {rep['p50_ms']:.1f} ms | p95 {rep['p95_ms']:.1f} ms | "
          f"mean batch {rep['mean_batch']:.1f} | "
          f"{rep['throughput_rps']:.2f} req/s | {errors} errors "
          f"({'sync' if args.sync else 'async'} flush"
          + (f", {server.shard_devices} shards a request"
             if server.shard_devices > 1 else "") + ")")
    for n, bb in rep["by_bucket"].items():
        print(f"  bucket {n}: {bb['requests']} requests | submit->result "
              f"mean {bb['mean_ms']:.1f} ms p95 {bb['p95_ms']:.1f} ms | "
              f"batch run mean {bb['run_mean_ms']:.1f} ms")
    for stage, s in rep["stages"].items():
        print(f"  stage {stage:<12} n={s['count']:<4} "
              f"mean {s['mean_ms']:.2f} ms  p95 {s['p95_ms']:.2f} ms  "
              f"total {s['total_s']:.3f} s")
    if auto:
        print(f"auto ladder {list(server.ladder())} | "
              f"hits {rep['bucket_hits']} misses {rep['bucket_misses']} "
              f"evictions {rep['bucket_evictions']} "
              f"calibrations {rep['bucket_calibrations']} "
              f"grown {rep['grown_buckets']} | "
              f"padding waste {rep['padding_waste_frac']:.1%}")
    print(f"cold start: compiles {rep['bucket_compiles']} cache loads "
          f"{rep['cache_loads']} calibrations {rep['bucket_calibrations']}")
    if args.trace_dir:
        paths = server.telemetry.export()
        print("telemetry artifacts: " + ", ".join(sorted(paths.values())))
    _save_artifact(server, args.save_artifact)
    for r in results[:3]:
        if r.error is not None:
            print(f"  req {r.request_id}: {r.error}")
            continue
        cp = r.fields[:, 0]
        print(f"  req {r.request_id}: bucket {r.bucket}, "
              f"cp range [{cp.min():.2f}, {cp.max():.2f}]")


def _save_artifact(server: GNNServer, path: Optional[str]):
    """``main``'s ``--save-artifact``: freeze the server after its traffic."""
    if path:
        info = server.save_artifact(path)
        print(f"deploy artifact -> {info['path']} (buckets "
              f"{info['buckets']}, ladder {info['ladder']})")


def _rollout_demo(server: GNNServer, reqs, args):
    """``main``'s rollout mode: every demo geometry as an
    ``--rollout-steps`` rollout, submitted at once and collected in id
    order; prints steps/s."""
    server.rollout_engine()               # construct before timing
    with server.telemetry.capture():
        t_roll = time.perf_counter()
        rids = [server.submit_rollout(v, f, n, steps=args.rollout_steps)
                for v, f, n in reqs]
        rollouts = [server.rollout_result(rid) for rid in rids]
        dt = time.perf_counter() - t_roll
    done = sum(r.steps_done for r in rollouts)
    errs = sum(1 for r in rollouts if r.error)
    print(f"rolled out {len(rollouts)} geometries x {args.rollout_steps} "
          f"steps ({done} total) on {server.device} in {dt:.2f}s | "
          f"{done / max(dt, 1e-9):.1f} steps/s | {errs} errors")
    for r in rollouts[:3]:
        if r.error is not None:
            print(f"  rollout {r.rollout_id}: {r.error}")
            continue
        cp = r.fields[:, 0]
        print(f"  rollout {r.rollout_id}: bucket {r.bucket}, "
              f"steps {r.steps_done}/{r.steps}, "
              f"cp range [{cp.min():.2f}, {cp.max():.2f}]")
    if args.trace_dir:
        paths = server.telemetry.export()
        print("telemetry artifacts: " + ", ".join(sorted(paths.values())))


if __name__ == "__main__":
    main()
