"""The xLSTM layer stack (xlstm-350m): groups of ``slstm_every - 1`` mLSTM
blocks and one sLSTM block, between the embedding and an RMSNorm and LM
head.

Port of the xLSTM part of ``repro.models.stacks`` (the zamba2-style hybrid
stack comes with Mamba2). Parameters are ``nn.Module``s named as the JAX
pytree, ``blocks[g].mlstm[i]`` and ``blocks[g].slstm`` for its ``blocks``
subtree stacked on a leading group axis (``models.convert.
xlstm_from_jax``). The recurrent state is a flat dict of tensors, each with
a leading group axis: ``mlstm.{i}.{conv,S,n,m}`` and ``slstm.{c,n,m,h}``
(JAX's ``{'mlstm': [...], 'slstm': {...}}`` stacked over groups). A forward
writes the new state into the dict it is given, in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import ssm
from repro_torch.models.nn import Dense, Embed, RMSNorm

State = Dict[str, torch.Tensor]


def xlstm_group_layout(cfg: ModelConfig):
    """(group_size, n_groups): each group is ``slstm_every - 1`` mLSTM
    blocks and one sLSTM block."""
    gs = cfg.ssm.slstm_every
    if cfg.n_layers % gs:
        raise ValueError(f"xLSTM: n_layers={cfg.n_layers} is not a multiple "
                         f"of slstm_every={gs}")
    return gs, cfg.n_layers // gs


class XLSTMGroup(nn.Module):
    def __init__(self, cfg: ModelConfig, gs: int, **init):
        super().__init__()
        self.mlstm = nn.ModuleList(ssm.MLSTM(cfg, **init)
                                   for _ in range(gs - 1))
        self.slstm = ssm.SLSTM(cfg, **init)


def xlstm_empty_state(cfg: ModelConfig, batch: int, device=None) -> State:
    """Zero state: conv inputs in ``cfg.dtype``, the rest float32, sLSTM
    ``m`` at -1e30, mLSTM ``m`` at 0."""
    gs, ng = xlstm_group_layout(cfg)
    one = {f"mlstm.{i}.{k}": t for i in range(gs - 1)
           for k, t in ssm.mlstm_empty_state(cfg, batch, device).items()}
    one.update({f"slstm.{k}": t for k, t in
                ssm.slstm_empty_state(cfg, batch, device).items()})
    return {k: t[None].repeat((ng,) + (1,) * t.dim())
            for k, t in one.items()}


def _sub(state: State, prefix: str, g: int) -> State:
    return {k[len(prefix):]: t[g] for k, t in state.items()
            if k.startswith(prefix)}


class XLSTM(nn.Module):
    """``embed``, ``blocks[g]``, ``final_norm``, ``lm_head``, as the JAX
    pytree."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        init = dict(generator=generator, device=device,
                    dtype=dtype or getattr(torch, cfg.dtype))
        gs, ng = xlstm_group_layout(cfg)
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, **init)
        self.blocks = nn.ModuleList(XLSTMGroup(cfg, gs, **init)
                                    for _ in range(ng))
        self.final_norm = RMSNorm(cfg.d_model, device=device,
                                  dtype=init["dtype"])
        self.lm_head = Dense(cfg.d_model, cfg.padded_vocab, use_bias=False,
                             **init)

    def forward(self, tokens, state: Optional[State] = None):
        """tokens (B, T) int; ``state`` from :func:`xlstm_empty_state` or a
        previous call (None: a fresh zero state, as JAX's prefill passes).
        Returns (logits (B, T, V_padded) f32, state), the state updated in
        place."""
        h = self.embed(tokens)
        if state is None:
            state = xlstm_empty_state(self.cfg, h.shape[0], h.device)
        for g, group in enumerate(self.blocks):
            for i, block in enumerate(group.mlstm):
                h, new = block(h, _sub(state, f"mlstm.{i}.", g))
                for k, t in new.items():
                    state[f"mlstm.{i}.{k}"][g] = t
            h, new = group.slstm(h, _sub(state, "slstm.", g))
            for k, t in new.items():
                state[f"slstm.{k}"][g] = t
        h = self.final_norm(h)
        return (h @ self.lm_head.w).float(), state


def xlstm_init(cfg: ModelConfig, seed: int = 0, device=None) -> XLSTM:
    """Random weights in ``cfg.dtype``, drawn on ``device`` (default: the
    card) from a generator on that device seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return XLSTM(cfg, generator=gen, device=dev)
