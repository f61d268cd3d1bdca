"""Layers of the MeshGraphNet and the decoder: dense, MLP, LayerNorm,
RMSNorm and the embedding table as ``nn.Module``s.

Parameters keep the JAX package's layout (``Dense.w`` is (in, out)) and
names, so a JAX param pytree loads one to one (``models.convert``). Weights
are drawn from an explicit ``torch.Generator``: the same LeCun-uniform
limits, normal embedding scale and zero biases as ``repro.models.nn``, but
not the same numbers, since ``jax.random`` and PyTorch's generator differ.
They are drawn in float32 on ``device`` (the generator's device), then cast
to ``dtype``: a 10 B-parameter model is drawn on the card, never on the
host. :func:`splittable` and :func:`whole` mark where a sharded layout must
change (a head split, a recurrence along time): they leave a plain tensor as
it is, and on the dry run's ``DTensor``s (``launch.dryrun``) gather the
shardings a later view cannot take. The dry run's other rules, for ops
``DTensor`` shards differently from GSPMD, live in ``launch.dryrun``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import sys

import torch
from torch import nn
from torch.nn import functional as F

ACTS = {
    "silu": F.silu,
    # jax.nn.gelu approximates with tanh by default; PyTorch's default is
    # the exact erf form
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (only the dry run makes them), read
    without importing ``torch.distributed.tensor``: until something has
    imported it, no tensor can be one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _gathered(t, pl):
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p is None else p for p in pl]
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t


def splittable(t, dim: int, n: int):
    """``t``, ready for a view that splits ``dim`` into ``n`` parts. A
    ``DTensor`` (the dry run's) sharded on ``dim`` over a mesh dim whose
    size does not divide ``n`` is gathered on that mesh dim first: DTensor
    cannot split a shard across the parts."""
    if is_dtensor(t):
        dim = dim % t.ndim
        t = _gathered(t, [None if p.is_shard(dim) and
                          n % t.device_mesh.size(i) else p
                          for i, p in enumerate(t.placements)])
    return t


def whole(t, *dims: int):
    """``t`` with ``dims`` whole on every device and no dim sharded over two
    mesh dims. A ``DTensor`` (the dry run's) can take the time dim sharded
    (a sequence-parallel layout), or the batch dim on 'data' and 'model'
    at once, from an elementwise op; a recurrence along time needs time
    whole, and a view of a twice-sharded dim, as inside ``einsum``, gets
    wrong local shapes. Such mesh dims are gathered."""
    if is_dtensor(t):
        dims = {d % t.ndim for d in dims}
        seen, pl = set(), []
        for p in t.placements:
            if p.is_shard() and (p.dim in dims or p.dim in seen):
                p = None
            elif p.is_shard():
                seen.add(p.dim)
            pl.append(p)
        t = _gathered(t, pl)
    return t


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` (in, out), LeCun-uniform initialized."""

    def __init__(self, in_dim: int, out_dim: int, *, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        limit = math.sqrt(1.0 / in_dim)
        w = torch.rand((in_dim, out_dim), generator=generator, device=device)
        self.w = nn.Parameter(w.mul_(2 * limit).sub_(limit).to(dtype))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device,
                                          dtype=dtype)) if use_bias else None

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


class LayerNorm(nn.Module):
    """LayerNorm as ``repro.models.nn.layernorm``: float32 upcast, biased
    variance, ``eps=1e-5``, result cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm as ``repro.models.nn.rmsnorm``: float32 upcast, ``eps=1e-6``
    (LayerNorm's is 1e-5), scale applied in float32, cast back."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(torch.square(xf).mean(dim=-1, keepdim=True)
                             + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class Embed(nn.Module):
    """Token embedding table (vocab, dim), normal times ``1/sqrt(dim)``.
    The lookup is ``F.embedding`` (a row gather), which ``DTensor`` shards
    as a vocabulary-parallel lookup (the dry run's) where an index would
    gather the whole table."""

    def __init__(self, vocab: int, dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        t = torch.randn((vocab, dim), generator=generator, device=device)
        self.table = nn.Parameter(t.mul_(1.0 / math.sqrt(dim)).to(dtype))

    def forward(self, ids):
        return F.embedding(ids.long(), self.table)


class MLP(nn.Module):
    """``len(dims) - 1`` dense layers with the activation between them and an
    optional trailing LayerNorm (MeshGraphNet's edge/node/encoder MLPs)."""

    def __init__(self, dims: Sequence[int], act: str = "silu", *,
                 final_layernorm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = ACTS[act]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], generator=generator)
            for i in range(len(dims) - 1))
        self.ln = LayerNorm(dims[-1]) if final_layernorm else None

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = self.act(x)
        if self.ln is not None:
            x = self.ln(x)
        return x
