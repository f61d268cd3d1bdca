"""``torch.profiler`` integration: capture and memory snapshots.

The PyTorch twin of ``repro.telemetry.profiler``. Two hooks, both opt-in
and both safe to call when telemetry is disabled (the named ranges in a
profile are the spans of :mod:`~repro_torch.telemetry.trace`, which follow
any running profiler):

* :func:`trace_capture`: a ``torch.profiler.profile`` of the host, on every
  thread where this torch can (``profile_all_threads``), and, where CUDA is
  available, the card, for a ``with`` region; on exit it writes a Chrome
  trace to ``<log_dir>/trace.json``. ``log_dir=None`` is a no-op.
* :func:`device_memory_snapshot`: ``torch.cuda.memory_stats`` per card
  (bytes in use, peak, ...), empty when the process has not used CUDA.

Plus :func:`warn_once`, a per-condition log deduplicator.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Optional

import torch

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


def all_threads_config():
    """The profiler's experimental config that records every thread's
    operations and ranges (the serving worker's spans beside the client
    threads'), or None where this torch has no ``profile_all_threads``."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace_capture(log_dir: Optional[str]):
    """Profile the ``with`` region with ``torch.profiler`` and write its
    Chrome trace to ``<log_dir>/trace.json``. ``log_dir=None`` is a no-op,
    so callers gate the capture with one argument."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            experimental_config=all_threads_config()) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_memory_snapshot() -> list:
    """One ``torch.cuda.memory_stats`` record per card, numeric values
    only: ``[{"device": "cuda:0", "platform": "gpu", "stats": {...}}]``;
    empty when CUDA has not been initialised in this process."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [{"device": f"cuda:{i}", "platform": "gpu",
             "stats": {k: v for k, v in torch.cuda.memory_stats(i).items()
                       if isinstance(v, (int, float))}}
            for i in range(torch.cuda.device_count())]


class _WarnOnce:
    """Per-condition log dedup: first occurrence warns at WARNING, repeats
    are counted and logged at DEBUG, so sustained bad traffic cannot flood
    the log with one line per request."""

    def __init__(self, logger: logging.Logger):
        self._log = logger
        self._seen: dict = {}
        self._lock = threading.Lock()

    def __call__(self, key, msg: str) -> bool:
        """Returns True when this was the first occurrence of ``key``."""
        with self._lock:
            n = self._seen.get(key, 0)
            self._seen[key] = n + 1
        if n == 0:
            self._log.warning("%s", msg)
            return True
        self._log.debug("%s (repeat %d)", msg, n)
        return False

    def count(self, key) -> int:
        with self._lock:
            return self._seen.get(key, 0)

    def reset(self):
        with self._lock:
            self._seen.clear()


def warn_once(logger: logging.Logger) -> _WarnOnce:
    """Build a warn-once gate bound to a module logger."""
    return _WarnOnce(logger)
