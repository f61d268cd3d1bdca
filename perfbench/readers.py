"""What the per-layer readers share. Each metric's own file
(``metrics/<name>.py``) counts the useful work it divides by from the
context's records with ``counts``, and calls one of these; a reader that
finds nothing to read returns ``None``, and the metric is left out of the
line (never a 0 in place of a share)."""
from __future__ import annotations

from typing import Optional

from perfbench import counts


def idle_fraction(ctx) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device."""
    tl = ctx["timeline"]
    if not tl.window_s:
        return None
    return 1.0 - tl.busy_s / tl.window_s


def kernel_roofline(ctx, kernel: str, useful_bytes: float) -> Optional[float]:
    """A kernel's share of its bytes bound, in %: the useful bytes of all
    the work the traced window did, over HBM bandwidth, over the device
    time of the kernel's launches in the trace. ``None`` where the kernel
    did not run (a later program may have merged it into another)."""
    secs = ctx["timeline"].seconds(kernel)
    if not secs or not useful_bytes:
        return None
    return counts.roofline_pct(useful_bytes, 0.0, secs)


def mfu(ctx, flops: float) -> Optional[float]:
    """Useful operations of the traced window over its length, in % of the
    TF32 tensor-core peak."""
    tl = ctx["timeline"]
    if not flops or not tl.window_s or not tl.device:
        return None
    return counts.mfu_pct(flops, tl.window_s)
