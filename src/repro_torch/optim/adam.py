"""Adam with cosine-annealing LR and global-norm gradient clipping, on lists
of tensors (port of ``repro.optim.adam``).

The paper's training recipe: Adam, cosine annealing 1e-3 -> 1e-6, gradient
clipping at global norm 32. Parameters, gradients and moments are lists in
one order (for the MeshGraphNet, ``MeshGraphNet.leaves()``; for an LLM,
``models.convert.llm_leaves``: the JAX pytree's leaf order, which
``global_norm`` sums in). The arithmetic is the JAX package's, in f32: the
schedule's ``cos`` in f32, bias correction ``b ** step`` in f32, ``mhat /
(sqrt(vhat) + eps)``, clip scale ``min(1, max_norm / (norm + 1e-12))``.
Moments are f32 whatever the parameter's dtype; a bf16 gradient is clipped
in f32 and cast back, as JAX's ``clip_by_global_norm`` does, and a bf16
parameter is updated in f32 and cast back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Sequence

import torch


@dataclass(frozen=True)
class AdamConfig:
    lr_max: float = 1e-3
    lr_min: float = 1e-6
    total_steps: int = 10_000
    warmup_steps: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 32.0


class AdamState(NamedTuple):
    step: torch.Tensor            # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def cosine_lr(cfg: AdamConfig, step):
    """Cosine annealing from lr_max to lr_min with optional linear warmup;
    ``step`` a tensor, the result an f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_max - cfg.lr_min) * (
        1.0 + torch.cos(math.pi * t))
    return warm * cos if cfg.warmup_steps > 0 else cos


def global_norm(tensors: Sequence[torch.Tensor]):
    """sqrt of the sum, in the list's order, of each tensor's sum of
    squares in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    dev = params[0].device if params else None
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params],
        nu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params])


def adam_update(cfg: AdamConfig, grads: Sequence[torch.Tensor],
                state: AdamState, params: Sequence[torch.Tensor]):
    """One Adam step. Returns (new_params, new_state, metrics); the inputs
    are not modified."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
    return new_p, AdamState(step, new_m, new_v), {"grad_norm": gnorm,
                                                  "lr": lr}
