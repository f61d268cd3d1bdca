"""The layer stacks of the recurrent families, between the embedding and an
RMSNorm and LM head.

* The xLSTM stack (xlstm-350m): groups of ``slstm_every - 1`` mLSTM blocks
  and one sLSTM block.
* The zamba2-style hybrid (zamba2-2.7b): groups of ``attn_every - 1``
  Mamba2 blocks and ONE shared attention+FFN block (``transformer.Layer``),
  whose weights serve every group while each occurrence keeps its own KV
  cache. As in the JAX package, zamba2's per-occurrence LoRA deltas on the
  shared block are omitted. Its prefill attention goes through the flash
  kernel, once per group. The Mamba2 blocks and the shared block are
  marked for ``torch.profiler`` (``hybrid.mamba2``,
  ``hybrid.shared_attention``).

Port of ``repro.models.stacks``. Parameters are ``nn.Module``s named as the
JAX pytree, ``blocks[g].mlstm[i]``, ``blocks[g].slstm`` and
``blocks[g].mamba[i]`` for its ``blocks`` subtree stacked on a leading
group axis (``models.convert.xlstm_from_jax``, ``hybrid_from_jax``). The
recurrent state is a flat dict of tensors, each with a leading group axis:
``mlstm.{i}.{conv,S,n,m}`` and ``slstm.{c,n,m,h}`` (JAX's ``{'mlstm':
[...], 'slstm': {...}}`` stacked over groups); ``mamba.{i}.{conv,S}`` and
``attn_kv.{k,v}`` (JAX's ``{'mamba': [...], 'attn_kv': {k, v}}``). A
forward writes the new state into the dict it is given, in place.

Training (``mode="train"``) keeps no state: every block starts from JAX's
zero state and nothing is written in place, so autograd differentiates the
whole stack; the hybrid's shared attention is the plain causal attention
(``transformer.attend``), never the kernel; with ``cfg.remat == "full"``
each group runs under ``transformer.remat_wrap``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.nn import Dense, Embed, RMSNorm
from repro_torch.telemetry import span

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

    def forward(self, tokens, state: Optional[State] = None,
                mode: str = "prefill"):
        """tokens (B, T) int; ``state`` from :func:`xlstm_empty_state` or a
        previous call (None: a fresh zero state, as JAX's prefill passes).
        Returns (logits (B, T, V_padded) f32, state), the state updated in
        place. ``mode="train"`` (no state) starts every block from the zero
        state, keeps none and returns (logits, None)."""
        h = self.embed(tokens)
        if mode == "train":
            if state is not None:
                raise ValueError("xLSTM: training runs without a state")
            body = tfm.remat_wrap(_xlstm_group_train, self.cfg)
            for group in self.blocks:
                h = body(group, h)
            h = self.final_norm(h)
            return (h @ self.lm_head.w).float(), None
        if mode != "prefill":
            raise ValueError(f"xLSTM: mode must be 'prefill' or 'train', "
                             f"got {mode!r}")
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


def _xlstm_group_train(group: XLSTMGroup, h):
    """One group in training: each block from the zero state (None)."""
    for block in group.mlstm:
        h, _ = block(h)
    h, _ = group.slstm(h)
    return h


def xlstm_init(cfg: ModelConfig, seed: int = 0, device=None) -> XLSTM:
    """Random weights in ``cfg.dtype``, drawn on ``device`` (default: the
    card) from a generator on that device seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return XLSTM(cfg, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# zamba2-style hybrid stack
# ---------------------------------------------------------------------------

def hybrid_group_layout(cfg: ModelConfig):
    """(group_size, n_groups): each group is ``attn_every - 1`` Mamba2
    blocks and one occurrence of the shared attention block."""
    ae = cfg.attn_every
    if ae < 2 or cfg.n_layers % ae:
        raise ValueError(f"hybrid: n_layers={cfg.n_layers} is not a "
                         f"multiple of attn_every={ae} >= 2")
    return ae, cfg.n_layers // ae


class HybridGroup(nn.Module):
    def __init__(self, cfg: ModelConfig, ae: int, **init):
        super().__init__()
        self.mamba = nn.ModuleList(ssm.Mamba2(cfg, **init)
                                   for _ in range(ae - 1))


def hybrid_empty_state(cfg: ModelConfig, batch: int, seq_len: int,
                       device=None) -> State:
    """Zero state: each group's Mamba2 states (conv in ``cfg.dtype``, S
    float32) and its occurrence's KV cache ``attn_kv.{k,v}`` (G, B,
    seq_len, KV, hd) in bf16, as in JAX, whatever ``cfg.dtype``."""
    ae, ng = hybrid_group_layout(cfg)
    state = {f"mamba.{i}.{k}": t.new_zeros((ng,) + t.shape)
             for i in range(ae - 1)
             for k, t in ssm.mamba2_empty_state(cfg, batch, device).items()}
    kv = (ng, batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    for name in ("attn_kv.k", "attn_kv.v"):
        state[name] = torch.zeros(kv, dtype=torch.bfloat16, device=device)
    return state


class Hybrid(nn.Module):
    """``embed``, ``blocks[g].mamba[i]``, ``shared_attn`` (one
    ``transformer.Layer`` with an FFN), ``final_norm``, ``lm_head``, as the
    JAX pytree."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        init = dict(generator=generator, device=device,
                    dtype=dtype or getattr(torch, cfg.dtype))
        ae, ng = hybrid_group_layout(cfg)
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, **init)
        self.blocks = nn.ModuleList(HybridGroup(cfg, ae, **init)
                                    for _ in range(ng))
        self.shared_attn = tfm.Layer(cfg, use_moe=False, **init)
        self.final_norm = RMSNorm(cfg.d_model, device=device,
                                  dtype=init["dtype"])
        self.lm_head = Dense(cfg.d_model, cfg.padded_vocab, use_bias=False,
                             **init)

    def forward(self, tokens, state: Optional[State] = None,
                mode: str = "train", decode_pos: Optional[int] = None):
        """tokens (B, S) int. 'train' (no state): the stack over the whole
        sequence, the shared attention plain, each group through
        ``remat_wrap``; returns (logits, None). 'prefill': ``state`` from
        :func:`hybrid_empty_state` (zeros); the Mamba2 states are written
        in place and ``attn_kv`` becomes each occurrence's fresh K and V
        (G, B, S, KV, hd) in the model's dtype, as JAX's attention returns
        them. 'decode': one token at ``decode_pos`` against the padded
        state, updated in place. Returns (logits (B, S, V_padded) f32,
        state)."""
        h = self.embed(tokens)
        b, s = tokens.shape
        if mode == "decode":
            q_pos = torch.full((b, s), decode_pos, dtype=torch.int64,
                               device=h.device)
        else:
            q_pos = torch.arange(s, device=h.device)[None].expand(b, s)
        if mode == "train":
            if state is not None:
                raise ValueError("hybrid: training runs without a state")
            body = tfm.remat_wrap(self._group_train, self.cfg)
            for group in self.blocks:
                h = body(group, h, q_pos)
        elif mode in ("prefill", "decode"):
            if state is None:
                raise ValueError("hybrid: prefill and decode need a state "
                                 "(hybrid_empty_state)")
            fresh = []
            for g, group in enumerate(self.blocks):
                for i, block in enumerate(group.mamba):
                    with span("hybrid.mamba2"):
                        h, new = block(h, _sub(state, f"mamba.{i}.", g))
                        for k, t in new.items():
                            state[f"mamba.{i}.{k}"][g] = t
                ckv = None if mode != "decode" else \
                    (state["attn_kv.k"][g], state["attn_kv.v"][g])
                with span("hybrid.shared_attention"):
                    h, kv, _ = self.shared_attn(h, q_pos, window=None,
                                                mode=mode, cache_kv=ckv,
                                                decode_pos=decode_pos)
                fresh.append(kv)
            if mode == "prefill":
                state["attn_kv.k"] = torch.stack([k for k, _ in fresh])
                state["attn_kv.v"] = torch.stack([v for _, v in fresh])
        else:
            raise ValueError(f"hybrid: mode must be 'train', 'prefill' or "
                             f"'decode', got {mode!r}")
        h = self.final_norm(h)
        return (h @ self.lm_head.w).float(), state

    def _group_train(self, group: HybridGroup, h, q_pos):
        """One group in training: its Mamba2 blocks from the zero state,
        then the shared block's plain causal attention; no cache."""
        for block in group.mamba:
            with span("hybrid.mamba2"):
                h, _ = block(h)
        with span("hybrid.shared_attention"):
            h, _, _ = self.shared_attn(h, q_pos, window=None, mode="train")
        return h


def hybrid_init(cfg: ModelConfig, seed: int = 0, device=None) -> Hybrid:
    """Random weights in ``cfg.dtype`` (``A_log``, ``dt_bias`` and ``D`` in
    float32), drawn on ``device`` (default: the card) from a generator on
    that device seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Hybrid(cfg, generator=gen, device=dev)
