"""The port's compile cache: the CUDA kernels' build directory.

Port of ``repro.ckpt.compile_cache``. The JAX package caches XLA programs on
disk; the port runs eagerly and compiles no program, and what a restarted
process would compile again is its CUDA kernels: one ``nvcc`` run per
source (``repro_torch.kernels._build``), seconds each. Their libraries are
named by a hash of the source and the flags, so a directory of them is a
cache that is never stale. :func:`enable` points ``_build.BUILD_DIR`` at
such a directory, and a process that finds a kernel's library there loads
it instead of building it.

Attribution: :class:`CompileEvents` snapshots ``_build.counts``, whose
``misses`` count ``nvcc`` runs (a compile) and ``hits`` the libraries
loaded from disk (a cache load). The server splits a bucket's first call
into ``bucket_compiles`` and ``cache_loads`` by their delta, as the JAX
server splits its jit calls.

JAX's ``suspended()`` exists for AOT export only (an executable loaded
from its cache cannot be serialized); the port exports no executable, so
it has no counterpart.
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Optional, Tuple

from repro_torch.kernels import _build

log = logging.getLogger(__name__)

_lock = threading.Lock()
_enabled_dir: Optional[str] = None


def enable(cache_dir: Optional[str]) -> bool:
    """Point the kernels' build directory at ``cache_dir``.

    Idempotent; a falsy ``cache_dir`` is a no-op (returns whether a cache
    directory is enabled). Enabling a DIFFERENT directory logs a warning and
    switches: the build directory is process-global, so the last caller
    wins. Kernels already loaded stay loaded; the next one to load is
    looked up, or built, in the new directory.
    """
    global _enabled_dir
    if not cache_dir:
        with _lock:
            return _enabled_dir is not None
    with _lock:
        already = _enabled_dir
        if already == cache_dir:
            return True
        if already is not None:
            log.warning("compile cache moving from %s to %s (the kernels' "
                        "build directory is process-global: last caller "
                        "wins)", already, cache_dir)
        _build.BUILD_DIR = Path(cache_dir)
        _enabled_dir = cache_dir
    log.info("kernel compile cache enabled at %s", cache_dir)
    return True


def enabled_dir() -> Optional[str]:
    """The active cache directory, or None when none was enabled."""
    with _lock:
        return _enabled_dir


class CompileEvents:
    """Snapshot/delta view of the kernels' build and load counters.

    ``delta()`` returns ``(misses, hits)`` since the snapshot (or
    construction): ``nvcc`` runs and libraries loaded from disk. Both stay
    zero across a call whose kernels were loaded before it, or that runs
    none (the CPU path).
    """

    def __init__(self):
        self.snapshot()

    def snapshot(self) -> None:
        with _build._lock:
            self._misses = _build.counts["misses"]
            self._hits = _build.counts["hits"]

    def delta(self) -> Tuple[int, int]:
        with _build._lock:
            return (_build.counts["misses"] - self._misses,
                    _build.counts["hits"] - self._hits)
