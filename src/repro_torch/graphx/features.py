"""Node and edge featurization on tensors (port of ``repro.graphx.features``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def fourier_features(x, freqs: Sequence[float]):
    """sin/cos positional features (paper SV-A, frequencies 2pi/4pi/8pi).
    Empty ``freqs`` yields a 0-wide tensor."""
    parts = [x.new_zeros((*x.shape[:-1], 0), dtype=torch.float32)]
    for f in freqs:
        parts.append(torch.sin(math.pi * f * x))
        parts.append(torch.cos(math.pi * f * x))
    return torch.cat(parts, dim=-1).float()


def node_input_features(points, normals: Optional[torch.Tensor],
                        freqs: Sequence[float],
                        include_positions: bool = True):
    """Paper SV-A node inputs: positions + normals + Fourier features
    (3 + 3 + 6 * len(freqs) = 24 with the paper's 3 frequencies)."""
    parts = []
    if include_positions:
        parts.append(points.float())
    if normals is not None:
        parts.append(normals.float())
    parts.append(fourier_features(points, freqs))
    return torch.cat(parts, dim=-1)


def relative_edge_features(points, senders, receivers,
                           edge_mask: Optional[torch.Tensor] = None):
    """Relative position vector + its norm; masked edge slots are zero."""
    pts = points.float()
    rel = pts[senders.long()] - pts[receivers.long()]
    dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    feats = torch.cat([rel, dist], dim=-1)
    if edge_mask is not None:
        feats = feats * edge_mask[:, None].to(feats.dtype)
    return feats
