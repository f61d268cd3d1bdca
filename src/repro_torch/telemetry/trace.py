"""Span tracer: lightweight, thread-safe, nestable timing spans (the port
of ``repro.telemetry.trace``), and the spans that follow ``torch.profiler``.

One :class:`Tracer` records the lifecycle of every request / training step as
a tree of spans. Each span carries an interval on the span clock, the thread
it ran on, an optional ``trace_id`` tying it to one request (or one training
step), and the id of its enclosing span on the same thread — enough to
reconstruct the full nesting and to render the run in chrome://tracing.

The span clock, :func:`clock_ns`, is the one ``torch.profiler`` stamps its
events with: nanoseconds since the Unix epoch. A span's interval lies on a
profile's host and device timeline as it is, with no anchor.

A span follows the profiler. While a ``torch.profiler`` profile records
anywhere in the process (torch's process-wide ``_is_profiler_enabled``
flag; its ``_profiler_enabled()`` is per thread and reads False on a
thread the profile did not start on),
every :meth:`Tracer.span`, enabled tracer or not, also opens a
``record_function`` range of its name (a named range in the profile of the
thread that started the profile, or of every thread with
``profile_all_threads``) and lands a record in :data:`PROFILED`, one bounded
process-wide buffer that :func:`profiled_spans` reads by interval, whatever
thread the span ran on. Retroactive :meth:`Tracer.record_span` spans land
there too.

Design constraints (the serving hot path runs through this):

* **Zero-cost when off.** ``NULL_TRACER`` (and any tracer built with
  ``enabled=False`` via :func:`make_tracer`) returns one shared no-op
  context manager from :meth:`span` while no profiler records: one flag
  read, no allocation, no locking, no clock reads. The bound is pinned by
  ``tests/test_torch_telemetry.py``.
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

import torch
from torch.autograd import profiler as _autograd_profiler


def clock_ns() -> int:
    """The span clock: nanoseconds since the Unix epoch, the clock of
    ``torch.profiler``'s event stamps (``start_ns()``)."""
    return time.time_ns()


@dataclass(frozen=True)
class SpanRecord:
    """One finished span. Times are :func:`clock_ns` nanoseconds, the
    profiler's clock, on every thread."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]           # enclosing span on the same thread
    thread_id: int
    thread_name: str
    trace_id: Optional[str]            # request / step this span belongs to
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_ns": self.start_ns,
             "end_ns": self.end_ns, "duration_s": self.duration_s,
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
        self._t0 = 0

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
        self._t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = clock_ns()
        stack = tr._stack()
        # tolerate exception-driven unwinding out of order: pop through us
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        tr._record(SpanRecord(
            name=self.name, start_ns=self._t0, end_ns=t1,
            span_id=self.span_id, parent_id=self.parent_id,
            thread_id=threading.get_ident(),
            thread_name=threading.current_thread().name,
            trace_id=self.trace_id, attrs=self.attrs))
        return False


class _ProfiledSpan:
    """A span while a profiler records: a ``record_function`` range of its
    name around a span in :data:`PROFILED` and, when the tracer that opened
    it is enabled, one in that tracer."""
    __slots__ = ("_spans", "_range")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str], attrs: Dict[str, Any]):
        self._spans = [_ActiveSpan(PROFILED, name, trace_id, attrs)]
        if tracer.enabled and tracer is not PROFILED:
            self._spans.append(_ActiveSpan(tracer, name, trace_id, attrs))
        self._range = torch.profiler.record_function(name)

    def set(self, **attrs):
        self._spans[0].set(**attrs)     # the spans share one attrs dict
        return self

    def __enter__(self):
        self._range.__enter__()
        for s in self._spans:
            s.__enter__()
        return self

    def __exit__(self, *exc):
        for s in reversed(self._spans):
            s.__exit__(*exc)
        self._range.__exit__(*exc)
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
    All span times are :func:`clock_ns` stamps, so spans from different
    threads line up with each other and with a ``torch.profiler`` trace.
    """

    enabled = True

    def __init__(self, max_spans: int = 65536):
        self._spans: deque = deque(maxlen=max(int(max_spans), 1))
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    # ------------------------------------------------------------ recording

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
        """Open a nested span: ``with tracer.span("prepare", bucket=256):``
        (see the module docstring for what a running profiler adds)."""
        if _autograd_profiler._is_profiler_enabled:
            return _ProfiledSpan(self, name, trace_id, attrs)
        return _ActiveSpan(self, name, trace_id, attrs)

    def trace(self, trace_id: Optional[str]):
        """Bind a default ``trace_id`` for spans opened on this thread:
        ``with tracer.trace(f"req-{rid}"): ...``"""
        return _TraceContext(self, trace_id)

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    trace_id: Optional[str] = None, **attrs):
        """Record a span whose interval was measured externally — e.g. a
        request's queue wait, whose endpoints live on different threads.
        ``start_ns``/``end_ns`` are :func:`clock_ns` stamps."""
        self._record(SpanRecord(
            name=name, start_ns=start_ns, end_ns=end_ns,
            span_id=next(self._ids), parent_id=None,
            thread_id=threading.get_ident(),
            thread_name=threading.current_thread().name,
            trace_id=trace_id, attrs=attrs))
        if _autograd_profiler._is_profiler_enabled and self is not PROFILED:
            PROFILED.record_span(name, start_ns, end_ns, trace_id, **attrs)

    def instant(self, name: str, trace_id: Optional[str] = None, **attrs):
        """Record a zero-duration marker event."""
        t = clock_ns()
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
        """One JSON object per line per span; returns the span count."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r.to_dict(), sort_keys=True) + "\n")
        return len(recs)

    def export_chrome_trace(self, path: str) -> int:
        """Chrome ``trace_event`` JSON for chrome://tracing / Perfetto.

        Spans become "X" (complete) events; ``ts``/``dur`` are microseconds
        on the span clock (since the Unix epoch, as a ``torch.profiler``
        trace's). Thread names are emitted as metadata so the timeline
        groups rows by serving thread.
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
                "ts": r.start_ns / 1e3,
                "dur": max(r.end_ns - r.start_ns, 0) / 1e3,
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
    objects, except that a span or a ``record_span`` while a profiler
    records lands in :data:`PROFILED`. ``span()`` costs one flag read and no
    allocation otherwise."""

    enabled = False

    def __init__(self):                 # no buffer, no lock
        pass

    def span(self, name, trace_id=None, **attrs):
        if _autograd_profiler._is_profiler_enabled:
            return _ProfiledSpan(self, name, trace_id, attrs)
        return _NULL_SPAN

    def trace(self, trace_id):
        return _NULL_SPAN

    def record_span(self, name, start_ns, end_ns, trace_id=None, **attrs):
        if _autograd_profiler._is_profiler_enabled:
            PROFILED.record_span(name, start_ns, end_ns, trace_id, **attrs)

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

#: The spans recorded while a profiler ran, from every thread, bounded.
PROFILED = Tracer(max_spans=1 << 17)


def span(name: str, trace_id: Optional[str] = None, **attrs):
    """A span for code that holds no tracer (the pipeline, the models, the
    training step): a no-op unless a profiler records, then a
    ``record_function`` range and a record in :data:`PROFILED`."""
    return NULL_TRACER.span(name, trace_id, **attrs)


def profiled_spans(t0_ns: int, t1_ns: int) -> List[SpanRecord]:
    """Every span of :data:`PROFILED` that overlaps ``[t0_ns, t1_ns]`` (the
    span clock), oldest first: its name, thread, start and end, attributes,
    trace id and nesting."""
    return [r for r in PROFILED.records()
            if r.end_ns >= t0_ns and r.start_ns <= t1_ns]


def make_tracer(enabled: bool, max_spans: int = 65536) -> Tracer:
    """The one constructor call sites should use: a real tracer when
    telemetry is on, the shared no-op singleton when it is off."""
    return Tracer(max_spans=max_spans) if enabled else NULL_TRACER


def check_well_nested(records: List[SpanRecord]) -> List[str]:
    """Validate span nesting (used by tests and the CI smoke check).

    For every span with a parent: the parent must exist, live on the same
    thread, and contain the child's interval. Returns a
    list of human-readable violations — empty means well-nested.
    """
    by_id = {r.span_id: r for r in records}
    problems = []
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
        if r.start_ns < p.start_ns or r.end_ns > p.end_ns:
            problems.append(
                f"span {r.span_id} ({r.name}) [{r.start_ns},{r.end_ns}] "
                f"escapes parent {p.span_id} ({p.name}) "
                f"[{p.start_ns},{p.end_ns}]")
    return problems
