"""The traced run's device timeline, from ``torch.profiler``.

:func:`capture` profiles a window, marked by a host annotation, and
profiles it again when the trace holds no device operation:
``torch.profiler`` loses whole traces now and then (2 of 300 profiles of
10 launches on an H100 with torch 2.11). After :data:`TRIES` empty traces
it raises: an empty trace is never read as an idle device.

:class:`Timeline` reduces the raw events (never the event tree, which
takes minutes for 10^5 launches) to what the per-layer readers need: busy
seconds inside the window, device seconds and launches of a kernel by
name, the operations that took most time and the longest idle gaps with
what the host was doing meanwhile.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

TRIES = 3
WINDOW = "perfbench.window"


class EmptyTrace(RuntimeError):
    pass


@dataclass
class Timeline:
    window: Tuple[int, int]                     # ns, host clock of the trace
    device: List[Tuple[str, int, int]]          # (name, start, end), ns
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _merged(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device."""
        return sum(e - s for s, e in self._merged()) / 1e9

    def seconds(self, name: str) -> float:
        """Device seconds of the operations whose name holds ``name``."""
        return sum(e - s for n, s, e in self.device if name in n) / 1e9

    def launches(self, name: str) -> int:
        return sum(1 for n, _, _ in self.device if name in n)

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device:
            tot[name] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches of the window with nothing on the device,
        each named by the innermost traced host operation running at its
        middle (the profiler traces torch's operations, not Python or
        numpy)."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self._merged():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            over = [(he - hs, name) for name, hs, he in self.host
                    if hs <= mid <= he and name != WINDOW]
            out.append([min(over)[1] if over else
                        "no traced host op (Python, numpy)",
                        (e - s) / 1e9])
        return out


def _timeline(prof) -> Timeline:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append((ev.name(), s, e))
        elif ev.name() == WINDOW:
            window = (s, e)
        else:
            host.append((ev.name(), s, e))
    if window is None:
        raise EmptyTrace(f"the trace holds no '{WINDOW}' annotation")
    return Timeline(window=window, device=device, host=host)


def capture(run: Callable[[], object], *, on_retry: Callable = None,
            expect_device: bool = None):
    """``(result of run(), Timeline)``: ``run`` under ``torch.profiler``
    (host and device activity) inside the window annotation. ``run`` must
    do the same work each time it is called. ``expect_device`` (default:
    whether there is a card) makes a trace without device operations an
    empty one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if expect_device is None:
        expect_device = torch.cuda.is_available()
    for attempt in range(1, TRIES + 1):
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                out = run()
        tl = _timeline(prof)
        if tl.device or not expect_device:
            return out, tl
        if on_retry is not None and attempt < TRIES:
            on_retry(attempt)
    raise EmptyTrace(f"{TRIES} profiles of the window held no device "
                     "operation")
