"""Plain PyTorch attention: the flash kernel's reference, and its CPU path.

Exact softmax attention on flattened heads, with the JAX package's order of
operations (``repro.kernels.flash_attention.ref.attention``): float32 scores
divided by ``sqrt(hd)``, then the tanh softcap, then the causal and window
mask with ``-1e30``, then softmax and PV in float32, cast back to the input
dtype. It materialises the (BH, Sq, Skv) scores.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q, k, v, *, group_size: int = 1, causal: bool = True,
              window: Optional[int] = None,
              softcap: Optional[float] = None):
    """q (BH, Sq, hd); k, v (BH // group_size, Skv, hd) -> (BH, Sq, hd).

    Query row ``bh`` reads KV row ``bh // group_size``; positions are
    0-based in each tensor."""
    _, sq, hd = q.shape
    skv = k.shape[1]
    kf = k.repeat_interleave(group_size, dim=0).float()
    vf = v.repeat_interleave(group_size, dim=0).float()
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", w, vf).to(q.dtype)
