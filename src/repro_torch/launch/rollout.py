"""Transient-rollout engine: prefill / insert / generate serving, on PyTorch.

Port of ``repro.launch.rollout``. One request wants a T-step field rollout
of one geometry, not a single static prediction; the engine splits that
lifecycle as LLM decode engines do:

- **prefill**: build the multi-scale graph (the kNN kernel, once per level)
  and its step-invariant features ONCE per geometry, on the server's
  bucket ladder and calibration caches;
- **insert**: park the prefilled graph and the start state in the bucket's
  **slot table**, stacked ``(S, ...)`` tensors on the server's device whose
  leading axis is the slot, written in place (``copy_``);
- **generate**: advance every active rollout of a table by
  ``steps_per_flush`` physics steps per call. Where the JAX engine runs the
  slots as ``vmap`` lanes of one program, this loops over the active lanes,
  one graph at a time (a full-width lane-step's edge activations are the
  largest buffer), and skips the finished and idle ones: a lane-step
  launches the segment-sum kernel ``n_mp_layers`` times, a frozen lane
  nothing. Rollouts of different lengths and mid-flight arrivals
  interleave; ``remaining`` is mirrored on the host, so freeing or aborting
  a slot never touches the card.

Single-shot serving is the T=1 case: the serving forward pass is featurize
plus one step from a zero state, so a one-step rollout is bit-equal to
``GNNServer.serve`` (``tests/test_torch_rollout.py``).

Each flush waits for the card once: the nonfinite verdict is one
``abs().sum((1, 2))`` over the table's state, S floats copied to the host.
A failed flush (an error raised by the step, or by the card when the
verdict synchronises) aborts that table's in-flight rollouts and drops the
table; the next insert rebuilds it, as in JAX. Nothing falls back to the
CPU.

Resilience: fault sites ``rollout.prefill``, ``rollout.insert`` (fire, and
corrupt the host start state), ``rollout.generate`` and ``rollout.harvest``
(corrupt); the nonfinite guard aborts only the diverging rollout;
per-rollout deadlines expire queued and mid-flight rollouts; admission is
bounded by the server's ``max_queue_depth``.

Telemetry: per-flush ``rollout_generate`` spans, per-rollout
``rollout_submit`` / ``rollout_prefill`` / ``rollout_insert`` / ``rollout``
spans stitched by ``trace_id=roll-<rid>``, the ``ROLLOUT_STAGES``
histograms in ``stats.report()``, and the counters ``rollout_steps_total``,
``rollouts_completed_total``, ``rollouts_aborted_total``,
``rollouts_timed_out_total``, ``rollouts_rejected_total`` and the
``rollout_active_slots`` gauge on the server's registry.

Sharding: under the server's ``shard_devices > 1`` the table holds each
slot's shard plan, its buffers ``(P, S, Nmax, ...)`` with the slot on the
pack axis, and ``graphx.sharded.make_sharded_rollout_fn`` advances every
active lane's shards one after another; prefill is the host shard planning
(``shard.plan``), and each flush rebuilds each shard's graph, as in JAX.
With the default ``rollout_state_feats=False`` the field state never
re-enters message passing, so several steps a flush stay exact on owned
rows; with state feedback the halo rings cover exactly one step, so the
engine clamps to one step a flush and re-scatters the gathered global state
between flushes (``ShardPlan.gather`` then ``ShardPlan.scatter``: a halo
exchange on the host). A slot's shards are planned at the bucket's global
levels, as the server plans a request (JAX's engine passes the shard caps
there, which equal the levels only while each shard holds the whole cloud).
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphx import sharded
from repro_torch.graphx.pipeline import make_generate_fn, make_prefill_fn
from repro_torch.launch.serve_gnn import Request
from repro_torch.resilience import faults
from repro_torch.telemetry import clock_ns

ROLLOUT_STAGES = ("rollout_prefill", "rollout_insert", "rollout_generate",
                  "rollout_harvest")


@dataclass
class RolloutRequest:
    """One queued/active rollout (host bookkeeping; state lives on device)."""
    verts: np.ndarray
    faces: np.ndarray
    rollout_id: int
    steps: int
    bucket: int
    n_points: Optional[int] = None
    t_submit: float = 0.0
    deadline: Optional[float] = None
    t_submit_ns: int = 0                      # t_submit on the span clock
    init_state: Optional[np.ndarray] = None   # (bucket, node_out) start state
    cloud: Optional[tuple] = None             # (points, normals) override


@dataclass
class RolloutResult:
    rollout_id: int
    points: np.ndarray                 # (n, 3) sampled surface points
    fields: np.ndarray                 # (n, node_out) final field state
    steps: int                         # steps requested
    steps_done: int                    # steps actually advanced
    latency_s: float
    bucket: int
    error: Optional[str] = None


class _SlotTable:
    """Device-resident rollout state for ONE bucket size.

    Unsharded, every prefilled-graph leaf carries a leading slot axis
    ``(S, ...)`` and ``state`` is ``(S, n, node_out)``, created as zeros on
    the first insert. Sharded, ``graph`` is a shard batch ``(P, S, Nmax,
    ...)`` (its ``level_counts`` a host array), ``state`` ``(P, S, Nmax,
    node_out)``, and ``plans`` / ``gstate`` hold each slot's ``ShardPlan``
    and, under state feedback, its gathered global state (host numpy).
    ``remaining`` is mirrored on the host (each flush subtracts
    ``steps_per_flush`` deterministically), so freeing or aborting a slot
    never needs the card. ``lane_sum`` is the last flush's per-lane
    ``abs().sum`` of the state, on the host: the nonfinite verdict.
    """

    def __init__(self, size: int, slots: int):
        self.size = size
        self.slots = slots
        self.graph: Optional[Dict[str, torch.Tensor]] = None
        self.state: Optional[torch.Tensor] = None
        self.rem = np.zeros((slots,), np.int64)
        self.reqs: List[Optional[RolloutRequest]] = [None] * slots
        self.pts: List[Optional[np.ndarray]] = [None] * slots
        self.plans: List[Optional[sharded.ShardPlan]] = [None] * slots
        self.gstate: List[Optional[np.ndarray]] = [None] * slots
        self.lane_sum: Optional[np.ndarray] = None

    def free_slot(self) -> Optional[int]:
        for s, r in enumerate(self.reqs):
            if r is None:
                return s
        return None

    def active(self) -> List[int]:
        return [s for s, r in enumerate(self.reqs) if r is not None]

    def release(self, slot: int):
        self.reqs[slot] = None
        self.pts[slot] = None
        self.plans[slot] = None
        self.gstate[slot] = None
        self.rem[slot] = 0

    def nbytes(self) -> int:
        """Bytes the table holds on the device (0 before the first insert)."""
        if self.state is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in [self.state, *self.graph.values()]
                   if torch.is_tensor(t))


class RolloutEngine:
    """Prefill/insert/generate rollout serving on top of a ``GNNServer``.

    The engine composes with the server: it reuses the bucket ladder and
    routing (``_route``), the per-size calibration caches (``_calibrate``,
    ``_calibrate_shard``),
    the request-id space and the ``(seed, rid)`` surface sampling, the
    normalizer stats, the telemetry registry, the device and the resilience
    knobs. It is driven synchronously: every :meth:`generate` call is one
    flush (admit, advance, harvest); :meth:`result` drives flushes until
    the rollout resolves.
    """

    def __init__(self, server, *, slots: Optional[int] = None,
                 steps_per_flush: Optional[int] = None):
        cfg = server.cfg
        self.server = server
        self.slots = max(int(cfg.rollout_slots if slots is None else slots), 1)
        spf = int(cfg.rollout_steps_per_flush if steps_per_flush is None
                  else steps_per_flush)
        self.sharded_mode = server.shard_devices > 1
        if self.sharded_mode and cfg.rollout_state_feats and spf != 1:
            # the halo rings make each shard self-contained for exactly ONE
            # step once state re-enters message passing; more would read
            # stale halo state. Clamp + host halo exchange between flushes.
            warnings.warn(
                "sharded rollouts with rollout_state_feats=True are exact "
                "for one step per flush only (halo staleness): clamping "
                f"steps_per_flush {spf} -> 1")
            spf = 1
        self.steps_per_flush = max(spf, 1)
        self.timeout_s = float(cfg.rollout_timeout_s)
        self.max_pending = int(server.max_queue_depth)
        self._tables: Dict[int, _SlotTable] = {}
        self._prefill: Dict[int, object] = {}
        self._gen: Dict[int, object] = {}
        self._queue: deque = deque()
        self._results: Dict[int, RolloutResult] = {}
        self._lock = threading.RLock()
        m = server.telemetry.metrics
        self._c_steps = m.counter(
            "rollout_steps_total", help="physics steps advanced (all slots)")
        self._c_done = m.counter(
            "rollouts_completed_total", help="rollouts finished cleanly")
        self._c_abort = m.counter(
            "rollouts_aborted_total",
            help="rollouts aborted (nonfinite / fault / generate failure)")
        self._c_timeout = m.counter(
            "rollouts_timed_out_total", help="rollouts expired by deadline")
        self._c_reject = m.counter(
            "rollouts_rejected_total", help="rollouts shed at admission")
        self._g_active = m.gauge(
            "rollout_active_slots", help="slots currently mid-rollout")

    # ------------------------------------------------------------ programs

    def _programs(self, size: int):
        """(prefill, generate) for one bucket size, built once and cached;
        calibration rides the server's per-size caches. Sharded, prefill is
        None: the host shard planning takes its place."""
        if size not in self._gen:
            srv = self.server
            ms = srv._calibrate(size)
            if self.sharded_mode:
                self._prefill[size] = None
                self._gen[size] = sharded.make_sharded_rollout_fn(
                    srv.cfg, srv._calibrate_shard(size, ms),
                    steps=self.steps_per_flush, norm_in=srv._norm_in,
                    norm_out=srv._norm_out, pack_width=self.slots)
            else:
                self._prefill[size] = make_prefill_fn(srv.cfg, ms,
                                                      norm_in=srv._norm_in)
                self._gen[size] = make_generate_fn(
                    srv.cfg, steps=self.steps_per_flush,
                    norm_out=srv._norm_out)
        return self._prefill[size], self._gen[size]

    def _table(self, size: int) -> _SlotTable:
        t = self._tables.get(size)
        if t is None:
            t = self._tables[size] = _SlotTable(size, self.slots)
        return t

    def table_bytes(self) -> Dict[int, int]:
        """``{bucket: bytes its slot table holds on the device}``."""
        with self._lock:
            return {n: t.nbytes() for n, t in sorted(self._tables.items())}

    # ------------------------------------------------------------ submit

    def submit(self, verts: np.ndarray, faces: np.ndarray,
               n_points: Optional[int] = None, *, steps: int = 1,
               timeout_s: Optional[float] = None,
               init_state: Optional[np.ndarray] = None,
               cloud: Optional[tuple] = None) -> int:
        """Enqueue a T-step rollout; returns the rollout id.

        Ids come from the server's request-id space, so a rollout samples
        the same ``(seed, rid)`` surface cloud a single-shot request with
        that id would. ``init_state`` ((bucket, node_out)) seeds the field
        state (default zeros, the single-shot convention); ``cloud``
        replaces sampling with an explicit ``(points, normals)`` pair.
        ``timeout_s`` (default ``cfg.rollout_timeout_s``; 0/None = none)
        bounds the rollout end to end, queued or mid-generate.
        """
        srv = self.server
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces)
        bucket = srv._route(n_points, mutate=True)
        t0 = time.perf_counter()
        t0_ns = clock_ns()
        with srv._cond:
            rid = srv._next_id
            srv._next_id += 1
        if timeout_s is None:
            timeout_s = self.timeout_s or None
        req = RolloutRequest(
            verts=verts, faces=faces, rollout_id=rid, steps=max(int(steps), 1),
            bucket=bucket, n_points=n_points, t_submit=t0, t_submit_ns=t0_ns,
            deadline=None if not timeout_s else t0 + float(timeout_s),
            init_state=(None if init_state is None
                        else np.asarray(init_state, np.float32)),
            cloud=cloud)
        with self._lock:
            if self.max_pending > 0 and self.pending() >= self.max_pending:
                self._c_reject.inc()
                self._results[rid] = self._error_result(
                    req, f"rejected: rollout queue full "
                    f"(max_queue_depth={self.max_pending})", steps_done=0)
                return rid
            self._queue.append(req)
        srv.telemetry.tracer.record_span(
            "rollout_submit", t0_ns, clock_ns(), trace_id=f"roll-{rid}",
            bucket=bucket, steps=req.steps)
        return rid

    def pending(self) -> int:
        """Rollouts not yet resolved: queued + mid-flight."""
        return len(self._queue) + sum(len(t.active())
                                      for t in self._tables.values())

    # ------------------------------------------------------------ results

    def _error_result(self, req: RolloutRequest, reason: str,
                      steps_done: int) -> RolloutResult:
        t = time.perf_counter()
        return RolloutResult(
            rollout_id=req.rollout_id, points=np.zeros((0, 3), np.float32),
            fields=np.full((req.bucket, self.server.cfg.node_out), np.nan,
                           np.float32),
            steps=req.steps, steps_done=steps_done,
            latency_s=t - (req.t_submit or t), bucket=req.bucket,
            error=reason)

    def _finish(self, req: RolloutRequest, res: RolloutResult):
        self._results[req.rollout_id] = res
        srv = self.server
        t = clock_ns()
        srv.telemetry.tracer.record_span(
            "rollout", req.t_submit_ns or t, t,
            trace_id=f"roll-{req.rollout_id}", bucket=req.bucket,
            steps=res.steps_done, error=res.error)

    def result(self, rollout_id: int, *, drive: bool = True
               ) -> Optional[RolloutResult]:
        """Fetch (and pop) a rollout's result.

        With ``drive=True`` (default) this runs :meth:`generate` flushes
        until the rollout resolves; ``drive=False`` only polls (None when
        unresolved).
        """
        while True:
            with self._lock:
                res = self._results.pop(rollout_id, None)
                if res is not None:
                    return res
                if not drive or self.pending() == 0:
                    return None
            self.generate()

    def run_until_complete(self) -> int:
        """Drive flushes until nothing is pending; returns flush count."""
        flushes = 0
        while self.pending() > 0:
            self.generate()
            flushes += 1
        return flushes

    # ------------------------------------------------------------ admit

    def _admit_locked(self):
        now = time.perf_counter()
        kept = deque()
        while self._queue:
            req = self._queue.popleft()
            if req.deadline is not None and now > req.deadline:
                self._c_timeout.inc()
                self._finish(req, self._error_result(
                    req, f"rollout timed out after {self.timeout_s:.3f}s "
                    "before any generate flush", steps_done=0))
                continue
            table = self._table(req.bucket)
            slot = table.free_slot()
            if slot is None:
                kept.append(req)     # this bucket is full; others may admit
                continue
            try:
                self._insert_rollout(table, slot, req)
            except Exception as e:      # noqa: BLE001 — chaos/prefill failure
                self._c_abort.inc()
                self._finish(req, self._error_result(
                    req, f"prefill/insert failed: {e or e.__class__.__name__}",
                    steps_done=0))
        self._queue = kept

    def _init_state(self, req: RolloutRequest) -> np.ndarray:
        n, out = req.bucket, self.server.cfg.node_out
        if req.init_state is None:
            return np.zeros((n, out), np.float32)
        st = np.asarray(req.init_state, np.float32)
        if st.shape != (n, out):
            raise ValueError(
                f"init_state shape {st.shape} != bucket state ({n}, {out})")
        return st

    def _sample_cloud(self, req: RolloutRequest) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        if req.cloud is not None:
            pts, nrm = req.cloud
            return (np.asarray(pts, np.float32), np.asarray(nrm, np.float32))
        return self.server._sample(
            Request(req.verts, req.faces, req.rollout_id, req.n_points),
            req.bucket)

    def _insert_rollout(self, table: _SlotTable, slot: int,
                        req: RolloutRequest):
        """prefill (graph + featurize once), then park it in the slot table
        with in-place copies on the device."""
        srv = self.server
        prefill, _ = self._programs(table.size)
        t0 = time.perf_counter()
        faults.fire("rollout.prefill")
        pts, nrm = self._sample_cloud(req)
        st0 = self._init_state(req)
        st0 = faults.corrupt("rollout.insert", st0)
        if self.sharded_mode:
            self._insert_sharded(table, slot, req, pts, nrm, st0, t0)
            return
        dev = srv.device
        graph = prefill(torch.from_numpy(pts).to(dev),
                        torch.from_numpy(nrm).to(dev), table.size)
        t1, t1_ns = time.perf_counter(), clock_ns()
        srv.stats.record_stage("rollout_prefill", t1 - t0)
        faults.fire("rollout.insert")
        if table.graph is None:
            # the first insert materializes the table: zero lanes are inert
            # (emask False masks every edge; remaining 0 freezes the state)
            table.graph = {k: v.new_zeros((self.slots,) + tuple(v.shape))
                           for k, v in graph.items()}
            table.state = torch.zeros(
                (self.slots, table.size, srv.cfg.node_out),
                dtype=torch.float32, device=dev)
        for k, v in graph.items():
            table.graph[k][slot].copy_(v)
        table.state[slot].copy_(torch.from_numpy(st0))
        self._commit_slot(table, slot, req, pts, t1, t1_ns)

    def _insert_sharded(self, table: _SlotTable, slot: int,
                        req: RolloutRequest, pts, nrm, st0, t0: float):
        """Sharded prefill is the host shard planning (against the bucket's
        frozen spec, as the server plans a request); each flush builds the
        shards' graphs on the device."""
        srv = self.server
        ms = srv._calibrate(table.size)
        sspec = srv._calibrate_shard(table.size, ms)
        faults.fire("shard.plan")
        plan = sharded.plan_shards(
            pts, nrm, srv.shard_devices, srv.cfg.n_mp_layers,
            ms.level_sizes, srv.cfg.k_neighbors, method="geometric",
            spec=sspec)
        batch = plan.batch(srv.device)
        st_local = torch.from_numpy(plan.scatter(st0))
        t1, t1_ns = time.perf_counter(), clock_ns()
        srv.stats.record_stage("rollout_prefill", t1 - t0)
        faults.fire("rollout.insert")
        if table.graph is None:
            # every slot starts as a copy of the first plan: inert until a
            # slot is inserted (remaining 0 skips a lane)
            table.graph = {k: (np.repeat(v[:, None], self.slots, axis=1)
                               if k == "level_counts" else
                               v[:, None].repeat_interleave(self.slots, 1))
                           for k, v in batch.items()}
            table.state = torch.zeros(
                (srv.shard_devices, self.slots) + tuple(st_local.shape[1:]),
                dtype=torch.float32, device=srv.device)
        for k, v in batch.items():
            if k == "level_counts":
                table.graph[k][:, slot] = v
            else:
                table.graph[k][:, slot].copy_(v)
        table.state[:, slot].copy_(st_local)
        table.plans[slot] = plan
        table.gstate[slot] = np.asarray(st0)
        self._commit_slot(table, slot, req, pts, t1, t1_ns)

    def _commit_slot(self, table: _SlotTable, slot: int, req: RolloutRequest,
                     pts: np.ndarray, t1: float, t1_ns: int):
        srv = self.server
        table.reqs[slot] = req
        table.pts[slot] = pts
        table.rem[slot] = req.steps
        t2 = time.perf_counter()
        srv.stats.record_stage("rollout_insert", t2 - t1)
        tracer = srv.telemetry.tracer
        tracer.record_span("rollout_prefill", req.t_submit_ns, t1_ns,
                           trace_id=f"roll-{req.rollout_id}",
                           bucket=table.size)
        tracer.record_span("rollout_insert", t1_ns, clock_ns(),
                           trace_id=f"roll-{req.rollout_id}",
                           bucket=table.size, slot=slot)

    # ------------------------------------------------------------ generate

    def generate(self) -> int:
        """One flush: admit queued rollouts into free slots, advance every
        active table ``steps_per_flush`` steps, harvest finished / diverged
        / expired slots. Returns the number of rollouts still pending."""
        with self._lock:
            self._admit_locked()
            for size in sorted(self._tables):
                table = self._tables[size]
                if table.active():
                    self._advance_table(table)
                    self._harvest_table(table)
            self._g_active.set(sum(len(t.active())
                                   for t in self._tables.values()))
            return self.pending()

    def _advance_table(self, table: _SlotTable):
        srv = self.server
        _, gen = self._programs(table.size)
        spf = self.steps_per_flush
        with srv.telemetry.span("rollout_generate", bucket=table.size,
                                active=len(table.active()),
                                steps=spf) as sp:
            t0 = time.perf_counter()
            if not self._generate(table, gen):
                return
            advanced = int(np.minimum(table.rem, spf).sum())
            table.rem = np.maximum(table.rem - spf, 0)
            self._c_steps.inc(advanced)
            sp.set(advanced=advanced)
            t1 = time.perf_counter()
        srv.stats.record_stage("rollout_generate", t1 - t0)

    def _generate(self, table: _SlotTable, gen) -> bool:
        """One flush's generate and its per-lane verdict; False when it
        failed, its rollouts aborted and the table dropped."""
        srv = self.server
        try:
            faults.fire("rollout.generate")
            if self.sharded_mode:
                self._advance_sharded(table, gen)
            else:
                table.state, _ = gen(srv.params, table.graph, table.state,
                                     table.rem)
            # the flush's one wait for the card: S floats, the per-lane
            # verdict the harvest reads (NaN/Inf propagate through the sum)
            lanes = (0, 2, 3) if self.sharded_mode else (1, 2)
            table.lane_sum = table.state.abs().sum(lanes).cpu().numpy()
            return True
        except Exception as e:           # noqa: BLE001 — chaos/card failure
            # a failed flush kills THIS table's in-flight rollouts (their
            # state is unrecoverable) but not the queue or other buckets'
            # tables
            for slot in table.active():
                req = table.reqs[slot]
                self._c_abort.inc()
                self._finish(req, self._error_result(
                    req, f"generate flush failed: {e or e.__class__.__name__}",
                    steps_done=req.steps - int(table.rem[slot])))
                table.release(slot)
            # drop the tensors, as JAX drops its (possibly donated) arrays:
            # the next insert rebuilds a fresh table
            table.graph = None
            table.state = None
            table.lane_sum = None
            return False

    def _advance_sharded(self, table: _SlotTable, gen):
        """One sharded flush. Under state feedback, each active lane's
        global state is scattered onto its shards first, so halo rows carry
        their owners' current values (one exact step a flush: the engine
        clamped ``steps_per_flush`` to 1), and gathered back after."""
        srv = self.server
        feed = srv.cfg.rollout_state_feats
        if feed:
            for g, plan in enumerate(table.plans):
                if plan is not None:
                    table.state[:, g].copy_(torch.from_numpy(
                        plan.scatter(table.gstate[g])))
        table.state, _ = gen(srv.params, table.graph, table.state, table.rem)
        if feed:
            out = table.state.cpu().numpy()
            for g, plan in enumerate(table.plans):
                if plan is not None and table.rem[g] > 0:
                    table.gstate[g] = plan.gather(out[:, g])

    def _slot_fields(self, table: _SlotTable, slot: int) -> np.ndarray:
        """A slot's final state on the host, a copy: on the CPU the slot is
        host memory the next insert overwrites."""
        if not self.sharded_mode:
            return table.state[slot].to("cpu", copy=True).numpy()
        if self.server.cfg.rollout_state_feats:
            return np.array(table.gstate[slot])
        return table.plans[slot].gather(table.state[:, slot].cpu().numpy())

    # ------------------------------------------------------------ harvest

    def _harvest_table(self, table: _SlotTable):
        srv = self.server
        if table.state is None or not table.active():
            return                        # flush failed: slots already failed
        guard = srv.cfg.nonfinite_guard
        t0 = time.perf_counter()
        lane_ok = np.isfinite(table.lane_sum) if guard else None
        now = time.perf_counter()
        for slot in table.active():
            req = table.reqs[slot]
            done = req.steps - int(table.rem[slot])
            if guard and not lane_ok[slot]:
                # the diverging rollout dies; the other lanes are untouched
                srv.stats.bump("nonfinite_results")
                self._c_abort.inc()
                self._finish(req, self._error_result(
                    req, f"nonfinite state detected at rollout step {done} "
                    f"(bucket {table.size}, slot {slot}); rollout aborted",
                    steps_done=done))
                table.release(slot)
                continue
            if table.rem[slot] == 0:
                fields = faults.corrupt("rollout.harvest",
                                        self._slot_fields(table, slot))
                if guard and not np.isfinite(fields).all():
                    srv.stats.bump("nonfinite_results")
                    self._c_abort.inc()
                    self._finish(req, self._error_result(
                        req, "nonfinite output at rollout harvest "
                        f"(bucket {table.size}, slot {slot})",
                        steps_done=done))
                    table.release(slot)
                    continue
                t = time.perf_counter()
                self._c_done.inc()
                self._finish(req, RolloutResult(
                    rollout_id=req.rollout_id, points=table.pts[slot],
                    fields=fields, steps=req.steps, steps_done=done,
                    latency_s=t - (req.t_submit or t), bucket=table.size))
                table.release(slot)
                continue
            if req.deadline is not None and now > req.deadline:
                self._c_timeout.inc()
                self._finish(req, self._error_result(
                    req, f"rollout deadline expired mid-flight after "
                    f"{done}/{req.steps} steps", steps_done=done))
                table.release(slot)
        srv.stats.record_stage("rollout_harvest", time.perf_counter() - t0)
