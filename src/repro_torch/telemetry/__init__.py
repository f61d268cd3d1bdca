"""``repro_torch.telemetry``: spans, metrics, and ``torch.profiler`` hooks.

The port of ``repro.telemetry``, one import for the trainer's and the GNN
server's observability:

* :class:`~repro_torch.telemetry.trace.Tracer`: nestable, thread-safe spans
  with a per-step or per-request ``trace_id``, stamped on the profiler's
  clock; JSONL and Chrome ``trace_event`` exporters. Every span follows a
  running ``torch.profiler``: a ``record_function`` range of its name and a
  record in :data:`PROFILED`, which :func:`profiled_spans` reads by
  interval; :func:`span` is the span of code that holds no tracer.
* :class:`~repro_torch.telemetry.metrics.MetricsRegistry`: counters,
  gauges, fixed-bucket streaming histograms; Prometheus text and JSON
  snapshots.
* :mod:`~repro_torch.telemetry.profiler`: opt-in ``torch.profiler``
  capture of every thread, ``torch.cuda`` memory snapshots.

:class:`Telemetry` is the bundle call sites thread around, built from the
config's ``telemetry`` / ``trace_dir`` / ``profile_capture`` fields (or
explicitly). Its tracer is the shared no-op object when disabled; its
metrics registry is always live and costs O(1) per observation.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry,
                                           default_latency_buckets,
                                           default_size_buckets)
from repro_torch.telemetry.trace import (NULL_TRACER, PROFILED, NullTracer,
                                         SpanRecord, Tracer,
                                         check_well_nested, clock_ns,
                                         make_tracer, profiled_spans, span)
from repro_torch.telemetry import profiler
from repro_torch.telemetry.profiler import (device_memory_snapshot,
                                            trace_capture, warn_once)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "NullTracer", "NULL_TRACER", "PROFILED", "SpanRecord",
    "Telemetry", "make_tracer", "check_well_nested", "clock_ns", "span",
    "profiled_spans", "trace_capture",
    "device_memory_snapshot", "warn_once", "profiler",
    "default_latency_buckets", "default_size_buckets",
]

PROFILE_SUBDIR = "torch_profile"


class Telemetry:
    """The bundle a trainer or a server owns: tracer + metrics + capture
    flags.

    ``enabled`` gates the span tracer (a running profiler records the
    spans whatever it says); the metrics registry stays live either way.
    ``trace_dir`` is where
    :meth:`export` drops artifacts; ``profile`` additionally captures a
    ``torch.profiler`` trace under ``<trace_dir>/torch_profile`` for the
    duration of :meth:`capture`.
    """

    def __init__(self, enabled: bool = False,
                 trace_dir: Optional[str] = None, profile: bool = False,
                 max_spans: int = 65536,
                 metrics: Optional[MetricsRegistry] = None):
        self.enabled = bool(enabled)
        self.trace_dir = trace_dir or None
        self.profile = bool(profile) and self.enabled
        self.tracer = make_tracer(self.enabled, max_spans=max_spans)
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(enabled=False)

    @classmethod
    def from_config(cls, cfg, **kw) -> "Telemetry":
        """Build from ``GNNConfig``-style fields (``telemetry``,
        ``trace_dir``, ``profile_capture``), tolerant of configs without
        them."""
        return cls(enabled=getattr(cfg, "telemetry", False),
                   trace_dir=getattr(cfg, "trace_dir", "") or None,
                   profile=getattr(cfg, "profile_capture", False), **kw)

    # ------------------------------------------------------------- tracing

    def span(self, name: str, trace_id: Optional[str] = None, **attrs):
        return self.tracer.span(name, trace_id=trace_id, **attrs)

    def trace(self, trace_id: Optional[str]):
        return self.tracer.trace(trace_id)

    def capture(self):
        """Opt-in ``torch.profiler`` capture of every thread for a ``with``
        region."""
        log_dir = (os.path.join(self.trace_dir, PROFILE_SUBDIR)
                   if (self.profile and self.trace_dir) else None)
        return trace_capture(log_dir)

    # ------------------------------------------------------------- export

    def export(self, trace_dir: Optional[str] = None) -> dict:
        """Write every artifact into ``trace_dir``; returns their paths.

        Artifacts: ``trace.jsonl`` (span-per-line), ``trace_chrome.json``
        (chrome://tracing), ``metrics.prom`` (Prometheus text),
        ``metrics.json`` (snapshot incl. device-memory stats).
        """
        trace_dir = trace_dir or self.trace_dir
        if not trace_dir:
            raise ValueError("no trace_dir configured for telemetry export")
        os.makedirs(trace_dir, exist_ok=True)
        paths = {
            "trace_jsonl": os.path.join(trace_dir, "trace.jsonl"),
            "trace_chrome": os.path.join(trace_dir, "trace_chrome.json"),
            "metrics_prom": os.path.join(trace_dir, "metrics.prom"),
            "metrics_json": os.path.join(trace_dir, "metrics.json"),
        }
        self.tracer.export_jsonl(paths["trace_jsonl"])
        self.tracer.export_chrome_trace(paths["trace_chrome"])
        with open(paths["metrics_prom"], "w") as f:
            f.write(self.metrics.prometheus_text())
        self.metrics.write_snapshot(
            paths["metrics_json"],
            extra={"device_memory": device_memory_snapshot()})
        return paths
