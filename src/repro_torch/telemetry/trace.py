"""Span tracer: lightweight, thread-safe, nestable timing spans (a copy of
``repro.telemetry.trace``, which imports no JAX).

One :class:`Tracer` records the lifecycle of every request / training step as
a tree of spans. Each span carries a wall-clock interval, the thread it ran
on, an optional ``trace_id`` tying it to one request (or one training step),
and the id of its enclosing span on the same thread — enough to reconstruct
the full nesting and to render the run in chrome://tracing.

Design constraints (the serving hot path runs through this):

* **Zero-cost when off.** ``NULL_TRACER`` (and any tracer built with
  ``enabled=False`` via :func:`make_tracer`) returns one shared no-op
  context manager from :meth:`span` — no allocation, no locking, no clock
  reads. The bound is pinned by ``tests/test_torch_telemetry.py``.
* **Bounded memory.** Finished spans land in a ``deque(maxlen=max_spans)``;
  sustained traffic overwrites the oldest spans instead of growing forever
  (the same discipline ``ServerStats`` follows for latencies).
* **Thread-safe.** The active-span stack is thread-local (nesting never
  crosses threads); the finished-span buffer append takes one lock.

Spans that *logically* belong to one request but execute on different
threads (submit on a client thread, prepare/dispatch/harvest on the flush
worker) are stitched together by ``trace_id``, not by nesting.

Exports: :meth:`Tracer.export_jsonl` (one span per line, self-describing)
and :meth:`Tracer.export_chrome_trace` (``trace_event`` "X" complete events
for chrome://tracing / Perfetto).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class SpanRecord:
    """One finished span. Times are raw ``time.perf_counter()`` seconds —
    the same monotonic clock the serving/training code stamps requests
    with, so externally-measured intervals line up with spans exactly. The
    exporters re-anchor to the tracer's wall-clock epoch."""
    name: str
    t_start: float
    t_end: float
    span_id: int
    parent_id: Optional[int]           # enclosing span on the same thread
    thread_id: int
    thread_name: str
    trace_id: Optional[str]            # request / step this span belongs to
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def to_dict(self) -> dict:
        d = {"name": self.name, "t_start": self.t_start,
             "t_end": self.t_end, "duration_s": self.duration_s,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "thread_id": self.thread_id, "thread_name": self.thread_name,
             "trace_id": self.trace_id}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullSpan:
    """Shared no-op context manager: the entire disabled-telemetry path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):            # mirror _ActiveSpan.set
        return self


_NULL_SPAN = _NullSpan()


class _ActiveSpan:
    """A span currently open on some thread. Context-manager protocol;
    closing records a :class:`SpanRecord` into the tracer's buffer."""
    __slots__ = ("_tracer", "name", "span_id", "parent_id", "trace_id",
                 "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str], attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.trace_id = trace_id
        self.attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs):
        """Attach attributes discovered mid-span (batch size, bucket...)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        if stack:
            top = stack[-1]
            self.parent_id = top.span_id
            if self.trace_id is None:       # inherit the enclosing trace
                self.trace_id = top.trace_id
        if self.trace_id is None:
            self.trace_id = getattr(tr._local, "trace_id", None)
        stack.append(self)
        self._t0 = tr._now()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr._now()
        stack = tr._stack()
        # tolerate exception-driven unwinding out of order: pop through us
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        tr._record(SpanRecord(
            name=self.name, t_start=self._t0, t_end=t1,
            span_id=self.span_id, parent_id=self.parent_id,
            thread_id=threading.get_ident(),
            thread_name=threading.current_thread().name,
            trace_id=self.trace_id, attrs=self.attrs))
        return False


class _TraceContext:
    """Context manager binding a default ``trace_id`` for the thread."""
    __slots__ = ("_tracer", "_trace_id", "_prev")

    def __init__(self, tracer: "Tracer", trace_id: Optional[str]):
        self._tracer = tracer
        self._trace_id = trace_id
        self._prev = None

    def __enter__(self):
        local = self._tracer._local
        self._prev = getattr(local, "trace_id", None)
        local.trace_id = self._trace_id
        return self

    def __exit__(self, *exc):
        self._tracer._local.trace_id = self._prev
        return False


class Tracer:
    """Thread-safe span recorder with bounded memory.

    ``max_spans`` bounds the finished-span buffer (oldest dropped first).
    All span times share one epoch: wall clock at construction plus
    ``perf_counter`` deltas, so spans from different threads line up.
    """

    enabled = True

    def __init__(self, max_spans: int = 65536):
        self._spans: deque = deque(maxlen=max(int(max_spans), 1))
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # ------------------------------------------------------------ recording

    def _now(self) -> float:
        return time.perf_counter()

    def wall_time(self, t: float) -> float:
        """Convert a span timestamp to wall-clock seconds since the epoch."""
        return self._wall0 + (t - self._perf0)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord):
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(rec)

    def span(self, name: str, trace_id: Optional[str] = None, **attrs):
        """Open a nested span: ``with tracer.span("prepare", bucket=256):``"""
        return _ActiveSpan(self, name, trace_id, attrs)

    def trace(self, trace_id: Optional[str]):
        """Bind a default ``trace_id`` for spans opened on this thread:
        ``with tracer.trace(f"req-{rid}"): ...``"""
        return _TraceContext(self, trace_id)

    def record_span(self, name: str, t_start: float, t_end: float,
                    trace_id: Optional[str] = None, **attrs):
        """Record a span whose interval was measured externally — e.g. a
        request's queue wait, whose endpoints live on different threads."""
        self._record(SpanRecord(
            name=name, t_start=t_start, t_end=t_end,
            span_id=next(self._ids), parent_id=None,
            thread_id=threading.get_ident(),
            thread_name=threading.current_thread().name,
            trace_id=trace_id, attrs=attrs))

    def instant(self, name: str, trace_id: Optional[str] = None, **attrs):
        """Record a zero-duration marker event."""
        t = self._now()
        self.record_span(name, t, t, trace_id=trace_id, **attrs)

    # ------------------------------------------------------------ inspection

    def records(self) -> List[SpanRecord]:
        """Snapshot of finished spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def dropped(self) -> int:
        """Spans overwritten because the bounded buffer was full."""
        with self._lock:
            return self._dropped

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    # ------------------------------------------------------------- exporters

    def export_jsonl(self, path: str) -> int:
        """One JSON object per line per span; returns the span count.
        ``t_wall_start`` re-anchors the monotonic timestamps to wall time."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                d = r.to_dict()
                d["t_wall_start"] = self.wall_time(r.t_start)
                f.write(json.dumps(d, sort_keys=True) + "\n")
        return len(recs)

    def export_chrome_trace(self, path: str) -> int:
        """Chrome ``trace_event`` JSON for chrome://tracing / Perfetto.

        Spans become "X" (complete) events; ``ts``/``dur`` are microseconds
        relative to the tracer epoch. Thread names are emitted as metadata
        so the timeline groups rows by serving thread.
        """
        recs = self.records()
        events = []
        seen_threads = {}
        for r in recs:
            seen_threads.setdefault(r.thread_id, r.thread_name)
            args = dict(r.attrs)
            if r.trace_id is not None:
                args["trace_id"] = r.trace_id
            events.append({
                "name": r.name, "ph": "X", "pid": 1, "tid": r.thread_id,
                "ts": (r.t_start - self._perf0) * 1e6,
                "dur": max(r.duration_s, 0.0) * 1e6,
                "cat": "repro", "args": args,
            })
        for tid, tname in seen_threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": tname}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(recs)


class NullTracer(Tracer):
    """The disabled tracer: every operation is a no-op returning shared
    objects. ``span()`` costs one attribute lookup and no allocation."""

    enabled = False

    def __init__(self):                 # no buffer, no lock, no epoch
        pass

    def span(self, name, trace_id=None, **attrs):
        return _NULL_SPAN

    def trace(self, trace_id):
        return _NULL_SPAN

    def record_span(self, *a, **kw):
        pass

    def instant(self, *a, **kw):
        pass

    def records(self):
        return []

    def dropped(self):
        return 0

    def clear(self):
        pass

    def export_jsonl(self, path):
        with open(path, "w"):
            pass
        return 0

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return 0


NULL_TRACER = NullTracer()


def make_tracer(enabled: bool, max_spans: int = 65536) -> Tracer:
    """The one constructor call sites should use: a real tracer when
    telemetry is on, the shared no-op singleton when it is off."""
    return Tracer(max_spans=max_spans) if enabled else NULL_TRACER


def check_well_nested(records: List[SpanRecord]) -> List[str]:
    """Validate span nesting (used by tests and the CI smoke check).

    For every span with a parent: the parent must exist, live on the same
    thread, and contain the child's interval (small clock slack). Returns a
    list of human-readable violations — empty means well-nested.
    """
    by_id = {r.span_id: r for r in records}
    problems = []
    eps = 1e-6
    for r in records:
        if r.parent_id is None:
            continue
        p = by_id.get(r.parent_id)
        if p is None:
            # parent may have been dropped by the bounded buffer; only a
            # violation if nothing was dropped
            problems.append(f"span {r.span_id} ({r.name}): parent "
                            f"{r.parent_id} missing")
            continue
        if p.thread_id != r.thread_id:
            problems.append(f"span {r.span_id} ({r.name}): parent on "
                            f"different thread")
        if r.t_start < p.t_start - eps or r.t_end > p.t_end + eps:
            problems.append(
                f"span {r.span_id} ({r.name}) [{r.t_start:.6f},"
                f"{r.t_end:.6f}] escapes parent {p.span_id} ({p.name}) "
                f"[{p.t_start:.6f},{p.t_end:.6f}]")
    return problems
