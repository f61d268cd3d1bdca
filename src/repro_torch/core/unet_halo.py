"""Halo partitioning for voxel domains (paper SVI): the same scheme as the
graph case, applied to a 3D UNet. A partition is a slab of the domain along
one axis, extended by a halo that must cover the network's receptive field;
outputs on the halo are discarded and owned outputs stitched together,
equal to the full-domain forward pass when halo >= receptive field (on the
card to cuDNN's rounding: it picks its algorithm by shape, so a slab is not
bit-equal to the same voxels of the whole domain).

Port of ``repro.core.unet_halo``, on ``torch`` tensors. Includes the
paper's *empirical receptive-field finder*: run the network on a full
domain and on partitioned domains with growing halo; the smallest halo
whose stitched output matches is the receptive field.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def slab_partitions(extent: int, n_parts: int, halo: int,
                    align: int = 1) -> List[Tuple[slice, slice, slice]]:
    """Split [0, extent) into n_parts owned slabs (aligned to ``align``) with
    halo-extended slices. Returns (owned, extended, owned_within_extended)
    per partition. Extended slices are clipped to the domain and kept aligned
    so pooling windows coincide with the full-domain ones."""
    if extent % align:
        raise ValueError(f"extent {extent} is not a multiple of the "
                         f"alignment {align}")
    units = extent // align
    per = units // n_parts
    rem = units % n_parts
    out = []
    start = 0
    halo_u = -(-halo // align) * align
    for p in range(n_parts):
        size = (per + (1 if p < rem else 0)) * align
        o0, o1 = start, start + size
        e0 = max(0, o0 - halo_u)
        e1 = min(extent, o1 + halo_u)
        out.append((slice(o0, o1), slice(e0, e1), slice(o0 - e0, o1 - e0)))
        start = o1
    return out


def apply_partitioned(apply_fn: Callable, x, n_parts: int, halo: int,
                      axis: int = 1, align: int = 1) -> torch.Tensor:
    """Run ``apply_fn`` independently on each halo-extended slab of ``x``
    (axis is the spatial axis, default 1 = X of NDHWC) and stitch owned
    outputs. Mirrors paper SIII-D inference: predictions on halo nodes are
    discarded, the rest aggregated to reconstruct the full-domain output.
    ``x`` may stay on the host while ``apply_fn`` moves each slab to the
    card: only one slab is on the card at a time."""
    extent = x.shape[axis]
    parts = slab_partitions(extent, n_parts, halo, align)
    pieces = []
    for owned, ext, owned_in_ext in parts:
        idx = [slice(None)] * x.ndim
        idx[axis] = ext
        y = apply_fn(x[tuple(idx)])
        oidx = [slice(None)] * y.ndim
        oidx[axis] = owned_in_ext
        pieces.append(y[tuple(oidx)])
    return torch.cat(pieces, dim=axis)


def find_receptive_halo(apply_fn: Callable, x, *, axis: int = 1,
                        n_parts: int = 2, align: int = 1,
                        max_halo: int = 64, tol: float = 1e-5) -> int:
    """Paper SVI empirical approach: 'run the network on a full domain and
    compare with a partitioned domain using varying halo sizes; the smallest
    halo for which the two outputs match indicates the minimum required
    receptive field size.'"""
    full = apply_fn(x)
    halo = align
    while halo <= max_halo:
        part = apply_partitioned(apply_fn, x, n_parts, halo, axis, align)
        if float(torch.max(torch.abs(part - full))) <= tol:
            return halo
        halo += align
    raise ValueError(f"no halo <= {max_halo} reproduces the full output")
