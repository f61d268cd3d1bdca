"""Streaming metrics: named counters, gauges and fixed-bucket histograms (a
copy of ``repro.telemetry.metrics``, which imports no JAX).

The registry is the bounded-memory replacement for append-forever stat
lists: a :class:`Histogram` holds a fixed bucket array plus exact
sum/count/min/max, so percentile estimates and means cost O(n_buckets)
memory no matter how many observations stream through — the property that
fixes ``ServerStats``' unbounded ``latencies_s`` growth under sustained
traffic.

Exporters:

* :meth:`MetricsRegistry.prometheus_text` — Prometheus text exposition
  format (``# HELP`` / ``# TYPE``, cumulative ``_bucket{le=...}`` rows with
  ``+Inf``, ``_sum`` / ``_count``), scrape-ready.
* :meth:`MetricsRegistry.snapshot` / :meth:`write_snapshot` — one JSON
  object of every metric's current value, for the telemetry export and
  the bench breakdown fields.

Everything is thread-safe: each metric carries its own lock (an observe
never contends with an unrelated metric), the registry lock only guards
metric creation.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize to a legal Prometheus metric name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def default_latency_buckets() -> Tuple[float, ...]:
    """Log-spaced seconds from 100 us to ~100 s: covers a sub-ms kernel and
    a cold 4 s compile in the same histogram at ~23% resolution."""
    return tuple(1e-4 * (1.25893 ** i) for i in range(60))


def default_size_buckets(lo: int = 1, hi: int = 1 << 22) -> Tuple[float, ...]:
    """Power-of-two integer buckets (batch sizes, point counts)."""
    out, v = [], lo
    while v <= hi:
        out.append(float(v))
        v *= 2
    return tuple(out)


class Counter:
    """Monotone counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket streaming histogram with exact sum/count/min/max.

    ``buckets`` are ascending finite upper bounds; an implicit ``+Inf``
    bucket catches the tail. Memory is O(len(buckets)) forever. Quantiles
    are estimated by linear interpolation inside the covering bucket and
    clamped to the exact observed [min, max] — so small-sample quantiles
    stay sane (a single observation reports itself for every quantile).
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        bs = tuple(sorted(float(b) for b in
                          (buckets if buckets is not None
                           else default_latency_buckets())))
        if not bs:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self.bounds: Tuple[float, ...] = bs
        self._counts = [0] * (len(bs) + 1)        # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    # ------------------------------------------------------------ queries

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def _state(self):
        with self._lock:
            return list(self._counts), self._count, self._min, self._max

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]); 0.0 when empty."""
        counts, total, vmin, vmax = self._state()
        if total == 0:
            return 0.0
        rank = (q / 100.0) * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(vmin, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else vmax
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(min(frac, 1.0), 0.0)
                return float(min(max(est, vmin), vmax))
            cum += c
        return float(vmax)

    def snapshot(self) -> dict:
        counts, total, vmin, vmax = self._state()
        return {
            "count": total,
            "sum": self._sum,
            "mean": (self._sum / total) if total else 0.0,
            "min": vmin if total else None,
            "max": vmax if total else None,
            "p50": self.percentile(50) if total else None,
            "p95": self.percentile(95) if total else None,
            "p99": self.percentile(99) if total else None,
        }

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Prometheus-style (upper_bound, cumulative_count) incl. +Inf."""
        counts, total, _, _ = self._state()
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, total))
        return out


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    Re-requesting a name returns the existing metric; requesting it as a
    different kind raises (one name, one type — the Prometheus contract).
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, **kw):
        name = self.prefix + name
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, **kw)
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind.__name__.lower()}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram, buckets=buckets, help=help)

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def reset(self):
        """Drop every registered metric (bench phase boundaries)."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ exporters

    def snapshot(self) -> dict:
        """{name: value-or-histogram-summary} for every metric."""
        return {name: m.snapshot()
                for name, m in sorted(self.metrics().items())}

    def write_snapshot(self, path: str, extra: Optional[dict] = None):
        """Atomically write the JSON snapshot (tmp file + rename), so a
        tailing reader never sees a torn file."""
        snap = {"time": time.time(), "metrics": self.snapshot()}
        if extra:
            snap.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (scrape endpoint / textfile
        collector payload)."""
        lines: List[str] = []
        for name, m in sorted(self.metrics().items()):
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                for bound, cum in m.cumulative_buckets():
                    le = "+Inf" if math.isinf(bound) else repr(bound)
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {m.sum!r}")
                lines.append(f"{pname}_count {m.count}")
            else:
                v = m.value
                lines.append(f"{pname} {v!r}" if v else f"{pname} 0")
        return "\n".join(lines) + "\n"

