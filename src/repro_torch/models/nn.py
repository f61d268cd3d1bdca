"""Layers of the MeshGraphNet: dense, MLP and LayerNorm as ``nn.Module``s.

Parameters keep the JAX package's layout (``Dense.w`` is (in, out)) and
names, so a JAX param pytree loads one to one (``models.convert``). Weights
are drawn from an explicit ``torch.Generator``: the same LeCun-uniform
limits and zero biases as ``repro.models.nn``, but not the same numbers,
since ``jax.random`` and PyTorch's generator differ.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


class Dense(nn.Module):
    """``y = x @ w + b`` with ``w`` (in, out), LeCun-uniform initialized."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        limit = math.sqrt(1.0 / in_dim)
        w = torch.rand((in_dim, out_dim), generator=generator) * (2 * limit) \
            - limit
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    """LayerNorm as ``repro.models.nn.layernorm``: float32 upcast, biased
    variance, ``eps=1e-5``, result cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


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
