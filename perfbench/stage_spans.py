"""Idle device time that no serving stage explains, from the program's
spans.

While a profile records, the program lands every span, from every thread,
in a process-wide buffer on the profiler's clock
(``repro_torch.telemetry.profiled_spans``): the serving worker's stages
among them, which the profile itself records only on the thread that
started it. :func:`unexplained_idle` lays the stage spans over the traced
timeline; what is left of the window, with nothing on the device and no
stage open on any thread, is idle time the serving engine's stages do not
account for (the worker waiting for work, untraced code). With no spans it
is the idle fraction: nothing explains the idle time.
"""
from __future__ import annotations

from typing import Iterable, Optional

STAGES = ("prepare", "dispatch", "harvest", "publish")


def unexplained_idle(timeline, spans: Iterable,
                     stages=STAGES) -> Optional[float]:
    """The share of ``timeline.window`` with no device operation and no
    span named in ``stages`` open; ``spans`` hold ``name``, ``start_ns``
    and ``end_ns`` on the timeline's clock. ``None`` for an empty
    window."""
    lo, hi = timeline.window
    if hi <= lo:
        return None
    intervals = [(s, e) for _, s, e in timeline.device]
    intervals += [(r.start_ns, r.end_ns) for r in spans if r.name in stages]
    covered, at = 0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if e > at:
            covered += e - max(s, at)
            at = e
    return 1.0 - covered / (hi - lo)


def read(ctx) -> Optional[float]:
    """The metric of a serving cell's traced run; ``None`` where the
    program keeps no profiled spans."""
    try:
        from repro_torch.telemetry import profiled_spans
    except ImportError:
        return None
    tl = ctx["timeline"]
    return unexplained_idle(tl, profiled_spans(*tl.window))
