"""Deterministic fault injection for chaos tests (a copy of
``repro.resilience.faults``: the same sites, modes, arming and masks).

A small registry of **named injection sites** threaded through the hot
paths (serving dispatch/compile/harvest, the background worker loop,
bucket build/calibration, the rollout slot table, checkpoint write/rename,
the training batch).
Production code calls :func:`fire` / :func:`corrupt` at each site; with
nothing armed both are a single boolean check — the harness costs nothing
until a test arms it.

Arming is explicit and deterministic: ``FAULTS.arm(site, mode=...,
nth=N, times=K)`` makes the site misbehave on hits N .. N+K-1 (1-based;
``times=-1`` means forever). Three modes:

* ``"raise"``   — raise :class:`FaultError` (or a custom ``exc`` factory),
  simulating a crash / compile failure / OOM at that site.
* ``"delay"``   — sleep ``delay_s`` then continue, simulating a stall.
* ``"corrupt"`` — at :func:`corrupt` sites, return a NaN-filled (or
  ``fill``-filled) copy of the array, simulating device-side nonfinite
  garbage. The corruption mask is drawn from a RNG seeded by
  ``(seed, hit)`` so a chaos run is bit-reproducible (and draws the JAX
  package's mask for the same spec and hit).

The injector is thread-safe (the serving worker, checkpoint writer and
client threads all pass through it) and process-global (``FAULTS``), so a
test arms a site and the production code — wherever it runs — honors it.
Always pair ``arm`` with ``reset``/``disarm`` (or use the ``armed``
context manager); each test file that arms a site resets it in a fixture.

Known sites (grep for the literal to find the hook); the port has a hook at
every one, so a chaos test arms the same names in both packages:

====================  =====================================================
``serve.dispatch``    per-batch device dispatch (``_dispatch_inner``)
``serve.compile``     the bucket call (``_call_bucket``; JAX's
                      ``_call_compiled``) — simulates an out-of-memory or
                      build failure raised by the call
``serve.harvest``     harvested device output (corrupt site: NaN-fill)
``serve.worker``      top of each background worker iteration
``shard.plan``        per-geometry shard planning in the sharded dispatch
                      (``_plan_shards``, ``shard_devices > 1``) and the
                      sharded rollout insert — a firing plan resolves that
                      request (or rollout) to an error
``bucket.build``      bucket construction (``_build_bucket``)
``bucket.calibrate``  grid calibration (``_calibrate``)
``rollout.prefill``   per-rollout prefill, before sampling
                      (``RolloutEngine._insert_rollout``)
``rollout.insert``    the slot-table insert: fires after the prefill, and
                      corrupts the host start state before it (NaN-fill)
``rollout.generate``  one generate flush of a slot table
                      (``_advance_table``): fails that table's rollouts
``rollout.harvest``   a finished rollout's fields (corrupt site: NaN-fill)
``ckpt.write``        checkpoint payload write (before the temp file)
``ckpt.rename``       the atomic rename publishing a checkpoint
``train.batch``       prepared training batch (corrupt site: NaN-fill)
====================  =====================================================
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

SITES = (
    "serve.dispatch", "serve.compile", "serve.harvest", "serve.worker",
    "shard.plan", "bucket.build", "bucket.calibrate", "ckpt.write",
    "ckpt.rename", "train.batch",
)

_MODES = ("raise", "delay", "corrupt")


class FaultError(RuntimeError):
    """Raised by an armed ``mode="raise"`` fault site."""


@dataclass
class FaultSpec:
    """One armed site: when it fires and what it does."""
    site: str
    mode: str = "raise"
    nth: int = 1                 # first hit (1-based) that fires
    times: int = 1               # consecutive firing hits; -1 = forever
    exc: Optional[Callable[[str], BaseException]] = None
    delay_s: float = 0.0
    frac: float = 1.0            # corrupt: fraction of entries NaN-filled
    fill: float = float("nan")
    seed: int = 0                # corrupt-mask RNG seed
    hits: int = 0                # total passes through the site
    fired: int = 0               # passes that actually misbehaved

    def _should_fire(self) -> bool:
        if self.hits < self.nth:
            return False
        return self.times < 0 or self.hits < self.nth + self.times


class FaultInjector:
    """Thread-safe registry of armed fault sites (see module docstring)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._armed: Dict[str, FaultSpec] = {}
        # fast path: production code checks this one bool before touching
        # the lock, so an unarmed injector costs a single attribute read
        self._active = False

    # ----------------------------------------------------------- arming

    def arm(self, site: str, mode: str = "raise", **kw) -> FaultSpec:
        if mode not in _MODES:
            raise ValueError(f"fault mode must be one of {_MODES}, "
                             f"got {mode!r}")
        spec = FaultSpec(site=site, mode=mode, **kw)
        with self._lock:
            self._armed[site] = spec
            self._active = True
        return spec

    def disarm(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)
            self._active = bool(self._armed)

    def reset(self) -> None:
        """Disarm everything (test teardown)."""
        self.disarm()

    @contextmanager
    def armed(self, site: str, mode: str = "raise", **kw):
        spec = self.arm(site, mode, **kw)
        try:
            yield spec
        finally:
            self.disarm(site)

    def active(self) -> bool:
        return self._active

    def spec(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            return self._armed.get(site)

    def hits(self, site: str) -> int:
        s = self.spec(site)
        return s.hits if s is not None else 0

    def fired(self, site: str) -> int:
        s = self.spec(site)
        return s.fired if s is not None else 0

    # ----------------------------------------------------------- firing

    def _tick(self, site: str) -> Optional[FaultSpec]:
        """Count one pass through ``site``; return the spec iff it fires."""
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return None
            spec.hits += 1
            if not spec._should_fire():
                return None
            spec.fired += 1
            return spec

    def fire(self, site: str) -> None:
        """Raise/delay hook for control-flow sites (no data to corrupt)."""
        if not self._active:
            return
        spec = self._tick(site)
        if spec is None or spec.mode == "corrupt":
            return
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.exc is not None:
            raise spec.exc(site)
        raise FaultError(f"injected fault at {site!r} (hit {spec.hits})")

    def corrupt(self, site: str, arr: np.ndarray) -> np.ndarray:
        """Data hook: honor every mode; ``corrupt`` returns a filled copy.

        The corruption mask is seeded by ``(seed, hit index)`` so the same
        armed spec produces the same garbage on every run.
        """
        if not self._active:
            return arr
        spec = self._tick(site)
        if spec is None:
            return arr
        if spec.mode == "raise":
            if spec.exc is not None:
                raise spec.exc(site)
            raise FaultError(f"injected fault at {site!r} (hit {spec.hits})")
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return arr
        out = np.array(arr, dtype=np.float32, copy=True)
        if spec.frac >= 1.0:
            out[...] = spec.fill
        else:
            rng = np.random.default_rng((spec.seed, spec.hits))
            out[rng.random(out.shape) < spec.frac] = spec.fill
        return out


#: process-global injector: tests arm it, production sites consult it
FAULTS = FaultInjector()

# module-level conveniences so call sites read `faults.fire("serve.worker")`
arm = FAULTS.arm
disarm = FAULTS.disarm
reset = FAULTS.reset
armed = FAULTS.armed
active = FAULTS.active
fire = FAULTS.fire
corrupt = FAULTS.corrupt
