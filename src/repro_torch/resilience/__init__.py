"""Resilience layer: deterministic fault injection for chaos testing.

The training hot path and the checkpoint writer are threaded with named
injection sites (see :mod:`repro_torch.resilience.faults`); chaos tests arm
them to prove the stack degrades (skipped steps, checkpoint fallback)
instead of dying.
"""
from repro_torch.resilience.faults import (FAULTS, FaultError, FaultInjector,
                                           FaultSpec, SITES)

__all__ = ["FAULTS", "FaultError", "FaultInjector", "FaultSpec", "SITES"]
