"""Resilience layer: deterministic fault injection for chaos testing.

The serving and training hot paths and the checkpoint writer are threaded
with named injection sites (see :mod:`repro_torch.resilience.faults`); chaos
tests arm them to prove the stack degrades (quarantined buckets, error
results, skipped steps, checkpoint fallback) instead of dying.
"""
from repro_torch.resilience.faults import (FAULTS, FaultError, FaultInjector,
                                           FaultSpec, SITES)

__all__ = ["FAULTS", "FaultError", "FaultInjector", "FaultSpec", "SITES"]
