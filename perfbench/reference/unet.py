"""Plain PyTorch reference of X-UNet3D (arXiv:2411.17164 SVI): a 3D UNet of
``depth`` levels with ``blocks_per_level`` convolutions a block, each
after a per-voxel RMS norm over channels and followed by the activation,
2x max pooling on the way down, nearest 2x upsampling and a 1x1 conv on
the way up, attention gates on the skips, and a 1x1 head.

Written from the paper and the configuration; it imports nothing of the
program. The whole grid is computed in blocks of the reference's own
layout (``block`` owned planes along X with ``halo`` planes on each side,
both multiples of the pooling alignment); every operation is local, so a
block's owned voxels equal the unpartitioned forward's once the halo
covers the receptive field.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from perfbench.reference.gnn import precision, round_tf32

Weights = Dict[str, torch.Tensor]


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every weight; a conv's ``w`` is (cout, cin, k,
    k, k)."""
    k, n = cfg.kernel_size, cfg.blocks_per_level
    ch = [cfg.base_channels * 2 ** i for i in range(cfg.depth)]

    def conv(name, kk, cin, cout):
        return [(f"{name}.w", (cout, cin, kk, kk, kk)), (f"{name}.b", (cout,))]

    spec, cin = [], cfg.in_channels
    for i in range(cfg.depth):
        for j in range(n):
            spec += conv(f"enc.{i}.convs.{j}", k, cin if j == 0 else ch[i],
                         ch[i])
        cin = ch[i]
    for j, i in enumerate(reversed(range(cfg.depth - 1))):
        spec += conv(f"ups.{j}", 1, ch[i + 1], ch[i])
        if cfg.attention_gates:
            ci = max(ch[i] // 2, 1)
            spec += conv(f"gates.{j}.wx", 1, ch[i], ci)
            spec += conv(f"gates.{j}.wg", 1, ch[i], ci)
            spec += conv(f"gates.{j}.psi", 1, ci, 1)
        for m in range(n):
            spec += conv(f"dec.{j}.convs.{m}", k, 2 * ch[i] if m == 0
                         else ch[i], ch[i])
    return spec + conv("head", 1, ch[0], cfg.out_channels)


def init_weights(cfg, seed: int, device) -> Weights:
    """Every conv ``w`` uniform in +-sqrt(1 / (cin k^3)), drawn in one call
    on ``device`` from a generator seeded with ``seed``; biases 0."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_w = sum(math.prod(s) for n, s in spec if n.endswith(".w"))
    flat = torch.rand(n_w, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        if name.endswith(".w"):
            n = math.prod(shape)
            lim = math.sqrt(1.0 / math.prod(shape[1:]))
            out[name] = flat[at:at + n].view(shape).mul(2 * lim).sub_(lim)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _conv(W, name, x, tf32: bool):
    w = W[f"{name}.w"]
    if tf32 and not x.is_cuda:
        x, w = round_tf32(x), round_tf32(w)
    return F.conv3d(x, w, W[f"{name}.b"], padding=(w.shape[-1] - 1) // 2)


def _rms(x, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(torch.square(x), 1, keepdim=True) + eps)


def _act(x, act: str):
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    if act == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {act!r}")


def _block(W, name, x, cfg, tf32):
    for j in range(cfg.blocks_per_level):
        x = _act(_conv(W, f"{name}.convs.{j}", _rms(x), tf32), cfg.act)
    return x


def forward(W: Weights, cfg, x: torch.Tensor, tf32: bool = False
            ) -> torch.Tensor:
    """x (1, C_in, X, Y, Z) NCDHW -> (1, C_out, X, Y, Z)."""
    skips = []
    for i in range(cfg.depth):
        x = _block(W, f"enc.{i}", x, cfg, tf32)
        if i < cfg.depth - 1:
            skips.append(x)
            x = F.max_pool3d(x, 2)
    for j in range(cfg.depth - 1):
        x = _conv(W, f"ups.{j}", F.interpolate(x, scale_factor=2.0,
                                               mode="nearest"), tf32)
        skip = skips.pop()
        if cfg.attention_gates:
            q = F.relu(_conv(W, f"gates.{j}.wx", skip, tf32)
                       + _conv(W, f"gates.{j}.wg", x, tf32))
            skip = skip * torch.sigmoid(_conv(W, f"gates.{j}.psi", q, tf32))
        x = _block(W, f"dec.{j}", torch.cat([skip, x], 1), cfg, tf32)
    return _conv(W, "head", x, tf32)


@torch.no_grad()
def volume_fields(W: Weights, cfg, x_host: torch.Tensor, *, block: int,
                  halo: int, tf32: bool = False,
                  device=None) -> torch.Tensor:
    """The whole grid's fields, (1, X, Y, Z, C_out) on ``device``, from the
    (1, X, Y, Z, C_in) input ``x_host``, in blocks along X."""
    align = 2 ** (cfg.depth - 1)
    if block % align or halo % align:
        raise ValueError("block and halo must be multiples of "
                         f"{align} planes")
    extent = x_host.shape[1]
    device = device or x_host.device
    out = None
    with precision(tf32):
        for o0 in range(0, extent, block):
            o1 = min(o0 + block, extent)
            e0, e1 = max(0, o0 - halo), min(extent, o1 + halo)
            xb = x_host[:, e0:e1].to(device).permute(0, 4, 1, 2, 3)
            y = forward(W, cfg, xb.contiguous(), tf32)[:, :, o0 - e0:o1 - e0]
            if out is None:
                out = torch.empty((1, extent) + tuple(y.shape[3:])
                                  + (y.shape[1],), device=device)
            out[:, o0:o1] = y.permute(0, 2, 3, 4, 1)
            del xb, y
    return out
