"""Mixture-of-experts layer: capacity-based top-k routing.

Port of ``repro.models.moe``, per batch row as there (dispatch never
crosses rows):

  router logits (B, S, E) -> top-k -> per-row, per-expert capacity C
  dispatch: gather tokens into a (B, E, C, d) buffer, slot indices from a
  stable sort by expert id
  expert compute: the batched gated FFN (B, E, C, d) x (E, d, ff)
  combine: each slot weighted by its router weight, back to (B, S, d)

Assignments over capacity are dropped; the residual carries the token, as
in GShard/Switch. The expert products are ``torch.einsum`` (batched GEMMs),
as JAX computes them outside any kernel.

Where the port differs in form, not in result:
- top-k is the first k of a stable descending sort, so equal probabilities
  keep the lower expert index first, as ``lax.top_k`` does (``torch.topk``
  guarantees no order);
- the scatters of ``_dispatch_indices`` send a dropped assignment to a
  trash slot past the buffer, which is cut off (JAX's ``mode="drop"``),
  never into slot C - 1;
- the combine gathers each token's k slot outputs through ``pos`` and adds
  them in k order, in the activation dtype. JAX's ``segment_sum`` over slots
  is a scatter-add; on the card that would be atomics, whose order, and so
  whose bf16 result, changes from run to run. This one has a fixed order.

Training differentiates ``apply`` by autograd as JAX differentiates its
own: through the router's softmax and the top-k weights (the sort's
values), the scatter of the weights into their slots, the gathers and the
expert products; the slot indices carry no gradient, and the aux loss keeps
its gradient through the mean router probabilities (tested against
``jax.value_and_grad`` in ``tests/test_torch_train_llm_decoders.py``).

``apply`` marks its parts with spans (``telemetry.span``: ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``), so a
``torch.profiler`` profile can split a step's device time among them;
outside a profile a span costs one flag read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from repro_torch.configs.base import MoEConfig
from repro_torch.models.nn import ACTS
from repro_torch.telemetry import span


def _uniform(shape, lim: float, *, generator, device, dtype):
    """``U(-lim, lim)`` drawn in float32 and cast to ``dtype``, one slice of
    the leading axis at a time: an expert stack is never held in float32
    (at qwen3-moe's width that would be 805 MB a stack)."""
    out = torch.empty(shape, device=device, dtype=dtype)
    if out.device.type == "meta":
        return out
    for i in range(shape[0]):
        w = torch.rand(shape[1:], generator=generator, device=device)
        out[i] = w.mul_(2 * lim).sub_(lim)
    return out


class _Params(nn.Module):
    """A named group of parameters, as a JAX sub-dict of arrays."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


class MoE(nn.Module):
    """``router.w`` (d, E), ``w_gate``/``w_up`` (E, d, ff), ``w_down`` (E,
    ff, d) and, with shared experts, ``shared.{w_gate, w_up, w_down}`` of
    width ff * n_shared; the JAX pytree's names and layout, with JAX's
    uniform limits (not its numbers)."""

    def __init__(self, d_model: int, cfg: MoEConfig, act: str = "silu", *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.act = ACTS[act]
        e, ff = cfg.n_experts, cfg.d_ff_expert
        lim, lim_ff = math.sqrt(1.0 / d_model), math.sqrt(1.0 / ff)
        u = dict(generator=generator, device=device, dtype=dtype)
        self.router = _Params(w=_uniform((d_model, e), lim, **u))
        self.w_gate = nn.Parameter(_uniform((e, d_model, ff), lim, **u))
        self.w_up = nn.Parameter(_uniform((e, d_model, ff), lim, **u))
        self.w_down = nn.Parameter(_uniform((e, ff, d_model), lim_ff, **u))
        if cfg.n_shared_experts:
            sff = ff * cfg.n_shared_experts
            self.shared = _Params(
                w_gate=_uniform((d_model, sff), lim, **u),
                w_up=_uniform((d_model, sff), lim, **u),
                w_down=_uniform((sff, d_model), math.sqrt(1.0 / sff), **u))

    def forward(self, x):
        """x (B, S, d) -> (y (B, S, d), aux loss, a float32 scalar)."""
        return apply(self, x)


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    return max(int(seq_len * cfg.top_k * cfg.capacity_factor
                   / cfg.n_experts), 1)


def route(params: MoE, x, cfg: MoEConfig):
    """Softmax over experts, then top-k. Returns (weights (B, S, K) f32,
    expert_idx (B, S, K) int64, the Switch load-balance aux loss)."""
    logits = x.float() @ params.router.w.float()
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, expert_idx = top[..., :cfg.top_k], order[..., :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    e = cfg.n_experts
    f = F.one_hot(expert_idx, e).float().mean(dim=(1, 2))     # (B, E)
    pbar = probs.mean(dim=1)                                  # (B, E)
    aux = e * (f * pbar).sum(-1).mean()
    return weights, expert_idx, aux


def _dispatch_indices(expert_idx, n_experts: int, cap: int, weights=None):
    """``repro.models.moe._dispatch_indices`` batched over rows.

    expert_idx (B, S, K) int; weights (B, S, K) f32 or None. Returns
      src    (B, E, C) int64   token feeding each slot (0 if empty)
      src_ok (B, E, C) f32     slot validity
      pos    (B, S, K) int64   slot of each assignment (>= C: dropped)
      w_slot (B, E, C) f32     combine weight of each slot (0 if empty)
    """
    b, s, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(b, s * k).long()
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # by expert
    sorted_e = flat_e.gather(1, order)
    ranks = torch.arange(s * k, device=dev)
    first = torch.searchsorted(
        sorted_e,
        torch.arange(n_experts, device=dev).expand(b, -1).contiguous(),
        side="left")                                          # (B, E)
    pos_sorted = ranks - first.gather(1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    # a dropped assignment goes to the trash slot E * C, cut off below
    n_slots = n_experts * cap
    slot = torch.where(pos < cap, flat_e * cap + pos, n_slots)

    def scatter(values, dtype):
        buf = torch.zeros((b, n_slots + 1), dtype=dtype, device=dev)
        buf.scatter_(1, slot, values.to(dtype).expand(b, s * k))
        return buf[:, :n_slots].reshape(b, n_experts, cap)
    src = scatter(flat_tok, torch.int64)
    src_ok = scatter(torch.ones(s * k, device=dev), torch.float32)
    w_slot = torch.zeros((b, n_experts, cap), device=dev) if weights is None \
        else scatter(weights.reshape(b, s * k), torch.float32)
    return src, src_ok, pos.reshape(b, s, k), w_slot


def _shared(params: MoE, x):
    sp = params.shared
    return (params.act(x @ sp.w_gate) * (x @ sp.w_up)) @ sp.w_down


def apply(params: MoE, x):
    """x (B, S, d). Returns (y (B, S, d) in x's dtype, aux loss)."""
    cfg = params.cfg
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    with span("moe.route"):
        weights, expert_idx, aux = route(params, x, cfg)
    with span("moe.dispatch"):
        src, src_ok, pos, w_slot = _dispatch_indices(expert_idx, e, cap,
                                                     weights)
        xb = x.gather(1, src.reshape(b, e * cap, 1).expand(-1, -1, d))
        xb = xb.reshape(b, e, cap, d) * src_ok[..., None].to(x.dtype)
    with span("moe.experts"):
        g = torch.einsum("becd,edf->becf", xb, params.w_gate)
        u = torch.einsum("becd,edf->becf", xb, params.w_up)
        yb = torch.einsum("becf,efd->becd", params.act(g) * u,
                          params.w_down)
    with span("moe.combine"):
        yw = yb * w_slot[..., None].to(yb.dtype)             # (B, E, C, d)
        # each token's k slots in k order; a dropped assignment reads the
        # zero row appended at E * C
        yw = torch.cat([yw.reshape(b, e * cap, d),
                        yw.new_zeros((b, 1, d))], dim=1)
        slot = torch.where(pos < cap, expert_idx * cap + pos, e * cap)
        picked = yw.gather(1, slot.reshape(b, s * k, 1).expand(-1, -1, d))
        picked = picked.reshape(b, s, k, d)
        y = picked[:, :, 0]
        for i in range(1, k):
            y = y + picked[:, :, i]
    if hasattr(params, "shared"):
        with span("moe.shared"):
            y = y + _shared(params, x)
    return y.to(x.dtype), aux


def apply_dense_reference(params: MoE, x):
    """Every expert on every token, combined by the router weights; no
    capacity, nothing dropped (the tests' oracle)."""
    cfg = params.cfg
    weights, expert_idx, aux = route(params, x, cfg)
    g = torch.einsum("bsd,edf->bsef", x, params.w_gate)
    u = torch.einsum("bsd,edf->bsef", x, params.w_up)
    y_all = torch.einsum("bsef,efd->bsed", params.act(g) * u, params.w_down)
    onehot = F.one_hot(expert_idx, cfg.n_experts).to(x.dtype)  # (B,S,K,E)
    w = torch.einsum("bske,bsk->bse", onehot, weights.to(x.dtype))
    y = torch.einsum("bsed,bse->bsd", y_all, w)
    if hasattr(params, "shared"):
        y = y + _shared(params, x)
    return y.to(x.dtype), aux


def drop_rate(expert_idx, cfg: MoEConfig):
    """Fraction of assignments dropped at the configured capacity."""
    cap = capacity(cfg, expert_idx.shape[1])
    _, _, pos, _ = _dispatch_indices(expert_idx, cfg.n_experts, cap)
    return (pos >= cap).float().mean()
