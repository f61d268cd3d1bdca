"""Decoder transformer: GQA, rope, sliding window, softcaps, post norms, MoE.

Port of the serving path of ``repro.models.transformer``: the dense
decoders (gemma2: alternating local and global layers, attention and final
logit softcaps, pre and post norms, GeGLU, embeddings scaled by sqrt(d);
granite, yi: SwiGLU; starcoder2: LayerNorm and a biased GELU MLP), the MoE
decoders (``models.moe`` in place of the FFN; qwen3-moe with QK-norm,
deepseek-moe with shared experts and a dense first layer of width
``d_ff_expert * (top_k + n_shared_experts)``), and pixtral's decoder with
its stubbed vision prefix (``vision_proj`` of the caller's patch
embeddings, put before the tokens). Parameters are ``nn.Module``s named as
the JAX pytree, with ``blocks[g].layers[i]`` for the JAX ``blocks`` subtree
stacked on its leading group axis and ``first_layers[i]`` for the dense
first layers (``models.convert.transformer_from_jax``).

Prefill attention goes through ``kernels.flash_attention.ops.mha``: the CUDA
kernel on the card, its plain version on the CPU. Decode attention (one
query against the padded cache) is plain PyTorch, as the JAX package
computes it outside any kernel. Decode writes the new K and V into the cache
in place (JAX returns an updated copy): at full width the cache is 3.2 GB.
The layer stack is a Python loop over groups (the JAX ``lax.scan``).

Training (``mode="train"``, :func:`train_loss`) is JAX's: the plain
:func:`attend` (causal, query-chunked as JAX's ``_attend``) on both
devices, differentiated by autograd. The flash kernel has no backward, as
the JAX package's has none, and refuses to run where autograd would need
one. With ``cfg.remat`` ``"full"`` or ``"dots"`` each layer group runs under
``torch.utils.checkpoint`` (:func:`remat_wrap`), as JAX wraps its scanned
group body in ``jax.checkpoint`` with that policy.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.nn import (ACTS, Dense, Embed, LayerNorm, RMSNorm,
                                  is_dtensor, splittable)

Cache = Dict[str, torch.Tensor]


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim // 2, dtype=torch.float32,
                                   device=device) / (head_dim // 2))


def apply_rope(x, positions, theta: float):
    """x (..., S, H, hd); positions (..., S) int. Half-split (not
    interleaved) rotation, angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: Optional[float]):
    return logits if cap is None else cap * torch.tanh(logits / cap)


def _pick_q_chunk(sq: int) -> int:
    """Queries per chunk of :func:`attend`, as JAX's ``_pick_q_chunk``:
    all of them up to 2,048, else the largest of 2,048, 1,024, 512, 256 that
    divides ``sq``."""
    if sq <= 2048:
        return sq
    for c in (2048, 1024, 512, 256):
        if sq % c == 0:
            return c
    return sq


def attend(q, k, v, q_pos, kv_pos, *, window: Optional[int],
           cap: Optional[float], causal: bool = False):
    """Plain exact attention, ``repro.models.transformer._attend``: decode
    calls it with one query and ``causal=False``, training with the whole
    sequence. q (B, Sq, H, hd); k, v (B, Skv, KV, hd); kv_pos entries < 0
    mark invalid (future) cache slots; ``causal`` masks kv_pos > q_pos.
    Queries run in chunks of :func:`_pick_q_chunk`, so that no (Sq, Skv)
    score matrix of a long sequence is whole at once (the result does not
    depend on the chunking)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = splittable(q, 2, kvh).reshape(b, sq, kvh, h // kvh, hd)
    kf, vf = k.float(), v.float()
    valid = (kv_pos >= 0)[:, None, :]                 # (B, 1, Skv)

    def chunk(qc, pc):
        logits = torch.einsum("bckgd,bskd->bckgs", qc.float(),
                              kf) * (1.0 / math.sqrt(hd))
        logits = softcap(logits, cap)
        mask = valid
        if causal:
            mask = mask & (pc[:, :, None] >= kv_pos[:, None, :])
        if window is not None:
            mask = mask & (pc[:, :, None] - kv_pos[:, None, :] < window)
        logits = torch.where(mask[:, :, None, None, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bckgs,bskd->bckgd", w, vf).to(q.dtype)

    c = _pick_q_chunk(sq)
    out = torch.cat([chunk(qc, pc) for qc, pc in
                     zip(qg.split(c, dim=1), q_pos.split(c, dim=1))], dim=1)
    return out.reshape(b, sq, h, hd)


# matrix products with no batch dimension: what remat "dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` as the training stacks run a layer group (JAX's
    ``_remat_wrap``): as it is for ``remat="none"``; for ``"full"`` under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    group's inputs and runs its forward again in the backward pass; for
    ``"dots"`` (JAX's ``checkpoint_dots_with_no_batch_dims``) under a
    selective checkpoint that also keeps the outputs of the matrix products
    with no batch dimension (``aten.mm``, ``aten.addmm``: the weights'
    products) and recomputes everything else (attention's batched
    ``bmm``s, norms, activations)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        def wrapped(*args):
            return checkpoint(fn, *args, use_reentrant=False)
        return wrapped
    if cfg.remat == "dots":
        def dots(*args):
            return checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _dots_policy))
        return dots
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def split_heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd) (:func:`splittable`)."""
    t = splittable(t, -1, n)
    return t.reshape(*t.shape[:-1], n, hd)


def _norm(cfg: ModelConfig, **kw) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, **kw)
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, **kw)
    raise ValueError(f"unknown norm {cfg.norm!r}")


class Attention(nn.Module):
    """Self-attention with GQA, optional QK-norm and rope."""

    def __init__(self, cfg: ModelConfig, **init):
        super().__init__()
        self.cfg = cfg
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = Dense(d, h * hd, use_bias=False, **init)
        self.wk = Dense(d, kv * hd, use_bias=False, **init)
        self.wv = Dense(d, kv * hd, use_bias=False, **init)
        self.wo = Dense(h * hd, d, use_bias=False, **init)
        if cfg.qk_norm:
            dd = {k: v for k, v in init.items() if k != "generator"}
            self.q_norm = RMSNorm(hd, **dd)
            self.k_norm = RMSNorm(hd, **dd)

    def forward(self, x, q_pos, *, window: Optional[int], mode: str,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                decode_pos: Optional[int] = None, causal: bool = True):
        """mode 'prefill': x (B, S, d), returns (out, (k, v)); ``causal``
        False attends both ways (whisper's encoder). mode 'train': the same
        through the plain :func:`attend`, never the kernel; returns (out,
        None). mode 'decode': x (B, 1, d); ``cache_kv`` is the layer's (k,
        v) cache (B, Smax, KV, hd), written at ``decode_pos`` in place;
        returns (out, cache_kv)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = split_heads(self.wq(x), h, hd)
        k = split_heads(self.wk(x), kvh, hd)
        v = split_heads(self.wv(x), kvh, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if cfg.use_rope:
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, q_pos, cfg.rope_theta)
        if mode == "decode":
            ck, cv = cache_kv
            if not 0 <= decode_pos < ck.shape[1]:
                raise ValueError(f"decode_pos {decode_pos} outside the "
                                 f"cache of {ck.shape[1]} slots")
            ck[:, decode_pos:decode_pos + 1] = k
            cv[:, decode_pos:decode_pos + 1] = v
            slots = torch.arange(ck.shape[1], device=x.device)
            kv_pos = torch.where(slots <= decode_pos, slots, -1)
            out = attend(q, ck, cv, q_pos, kv_pos[None].expand(b, -1),
                         window=window, cap=cfg.attn_softcap)
            new_kv = cache_kv
        elif mode == "prefill":
            out = fa_ops.mha(q, k, v, causal=causal, window=window,
                             softcap=cfg.attn_softcap)
            new_kv = (k, v)
        elif mode == "train":
            out = attend(q, k, v, q_pos, q_pos, window=window,
                         cap=cfg.attn_softcap, causal=causal)
            new_kv = None
        else:
            raise ValueError(f"mode must be 'prefill', 'decode' or 'train', "
                             f"got {mode!r}")
        return self.wo(out.reshape(b, s, h * hd)), new_kv


class FFN(nn.Module):
    """Gated (``w_gate``, ``w_up``, ``w_down``) or plain (``w_in``,
    ``w_out``, with biases) feed-forward block, of width ``d_ff`` (default
    ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, **init):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.act = ACTS[cfg.act]
        if cfg.glu:
            self.w_gate = Dense(d, ff, use_bias=False, **init)
            self.w_up = Dense(d, ff, use_bias=False, **init)
            self.w_down = Dense(ff, d, use_bias=False, **init)
        else:
            self.w_in = Dense(d, ff, **init)
            self.w_out = Dense(ff, d, **init)

    def forward(self, x):
        if hasattr(self, "w_gate"):
            return self.w_down(self.act(self.w_gate(x)) * self.w_up(x))
        return self.w_out(self.act(self.w_in(x)))


class Layer(nn.Module):
    """One attention + FFN (``mlp``) or MoE (``moe``) layer, pre-norm, with
    gemma2's post norms."""

    def __init__(self, cfg: ModelConfig, *, use_moe: bool = False,
                 dense_ff: Optional[int] = None, **init):
        super().__init__()
        dd = {k: v for k, v in init.items() if k != "generator"}
        self.post_norms = cfg.post_norms
        self.ln1 = _norm(cfg, **dd)
        self.attn = Attention(cfg, **init)
        self.ln2 = _norm(cfg, **dd)
        if use_moe:
            self.moe = moe_lib.MoE(cfg.d_model, cfg.moe, cfg.act, **init)
        else:
            self.mlp = FFN(cfg, dense_ff, **init)
        if cfg.post_norms:
            self.ln1_post = _norm(cfg, **dd)
            self.ln2_post = _norm(cfg, **dd)

    def forward(self, x, q_pos, *, window, mode, cache_kv=None,
                decode_pos=None):
        """Returns (x, new_kv, aux): ``aux`` is the MoE load-balance loss,
        a float32 zero for an FFN layer."""
        attn_out, new_kv = self.attn(self.ln1(x), q_pos, window=window,
                                     mode=mode, cache_kv=cache_kv,
                                     decode_pos=decode_pos)
        if self.post_norms:
            attn_out = self.ln1_post(attn_out)
        x = x + attn_out
        h = self.ln2(x)
        if hasattr(self, "moe"):
            ff_out, aux = self.moe(h)
        else:
            ff_out = self.mlp(h)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.post_norms:
            ff_out = self.ln2_post(ff_out)
        return x + ff_out, new_kv, aux


class Group(nn.Module):
    def __init__(self, cfg: ModelConfig, gs: int, **init):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(cfg, use_moe=cfg.moe is not None, **init)
            for _ in range(gs))


def n_first_dense(cfg: ModelConfig) -> int:
    """Dense layers before the MoE stack (deepseek-moe: 1)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def group_structure(cfg: ModelConfig):
    """(group_size, n_groups, windows_per_group) of the layers after the
    dense first layers. ``alt_local_global`` pairs (local window, global);
    other patterns are homogeneous."""
    n_scanned = cfg.n_layers - n_first_dense(cfg)
    if cfg.layer_pattern == "alt_local_global":
        if n_scanned % 2:
            raise ValueError(f"alt_local_global needs an even number of "
                             f"layers, got {n_scanned}")
        return 2, n_scanned // 2, (cfg.sliding_window, None)
    return 1, n_scanned, (cfg.sliding_window,)


def empty_cache(cfg: ModelConfig, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Zero KV cache ``{'k', 'v'}``, each (G, gs, B, S, KV, hd), and with
    dense first layers ``{'first_k', 'first_v'}``, each (n_first, B, S, KV,
    hd): JAX's ``{'blocks': {k, v}, 'first': {k, v}}`` flattened."""
    gs, ng, _ = group_structure(cfg)
    tail = (batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {name: torch.zeros((ng, gs) + tail, dtype=dtype, device=device)
             for name in ("k", "v")}
    nfd = n_first_dense(cfg)
    if nfd:
        for name in ("first_k", "first_v"):
            cache[name] = torch.zeros((nfd,) + tail, dtype=dtype,
                                      device=device)
    return cache


class Transformer(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (unless tied),
    ``blocks[g].layers[i]``, ``first_layers[i]`` (dense first layers of an
    MoE decoder) and ``vision_proj`` (a vision frontend), as the JAX
    pytree."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        init = dict(generator=generator, device=device,
                    dtype=dtype or getattr(torch, cfg.dtype))
        dd = {k: v for k, v in init.items() if k != "generator"}
        gs, ng, _ = group_structure(cfg)
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, **init)
        self.final_norm = _norm(cfg, **dd)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.padded_vocab,
                                 use_bias=False, **init)
        self.blocks = nn.ModuleList(Group(cfg, gs, **init)
                                    for _ in range(ng))
        nfd = n_first_dense(cfg)
        if nfd:
            m = cfg.moe
            dense_ff = m.d_ff_expert * (m.top_k + m.n_shared_experts)
            self.first_layers = nn.ModuleList(
                Layer(cfg, dense_ff=dense_ff, **init) for _ in range(nfd))
        if cfg.frontend == "vision":
            self.vision_proj = Dense(cfg.d_model, cfg.d_model,
                                     use_bias=False, **init)

    def embed_tokens(self, tokens):
        h = self.embed(tokens)
        if self.cfg.scale_embeddings:
            h = (h.float() * math.sqrt(self.cfg.d_model)).to(h.dtype)
        return h

    def logits(self, h):
        w = self.embed.table.T if self.cfg.tie_embeddings else self.lm_head.w
        logits = (h @ w).float()
        cap = self.cfg.final_softcap
        if cap is not None and (logits.requires_grad
                                or is_dtensor(logits)):
            # out of place for autograd, and for a DTensor (the dry run's),
            # whose partial sums an in-place op cannot keep
            logits = softcap(logits, cap)
        elif cap is not None:
            # in place where autograd saves nothing: the f32 logits are a
            # prefill's largest tensor
            logits = logits.div_(cap).tanh_().mul_(cap)
        return logits

    def apply_decoder(self, h, q_pos, *, mode: str,
                      cache: Optional[Cache] = None,
                      decode_pos: Optional[int] = None):
        """Run the layer stack on embeddings h (B, S, d): the dense first
        layers, then the groups. Returns (h, cache, aux): for 'prefill' a
        new cache of the layers' K and V in h's dtype, for 'decode' the
        given cache, updated in place, for 'train' None; ``aux`` the layers'
        MoE load-balance losses summed (float32) in JAX's order."""
        if mode == "train":
            return self._train_stack(h, q_pos)
        _, _, windows = group_structure(self.cfg)
        new_cache = cache
        if mode == "prefill":
            new_cache = empty_cache(self.cfg, h.shape[0], h.shape[1],
                                    dtype=h.dtype, device=h.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        # (layer, window, cache key of k, of v, index into them)
        stack = [(layer, None, "first_k", "first_v", (i,))
                 for i, layer in enumerate(getattr(self, "first_layers",
                                                   ()))]
        stack += [(layer, windows[i], "k", "v", (g, i))
                  for g, group in enumerate(self.blocks)
                  for i, layer in enumerate(group.layers)]
        for layer, window, kname, vname, at in stack:
            ckv = None if mode != "decode" else \
                (cache[kname][at], cache[vname][at])
            h, (k, v), aux = layer(h, q_pos, window=window, mode=mode,
                                   cache_kv=ckv, decode_pos=decode_pos)
            aux_total = aux_total + aux
            if mode == "prefill":
                new_cache[kname][at] = k
                new_cache[vname][at] = v
        return h, new_cache, aux_total

    def _train_stack(self, h, q_pos):
        """The stack in 'train' mode: the dense first layers, then each
        group through :func:`remat_wrap`. Returns (h, None, aux)."""
        _, _, windows = group_structure(self.cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in getattr(self, "first_layers", ()):
            h, _, a = layer(h, q_pos, window=None, mode="train")
            aux = aux + a

        def group_body(group, h, aux):
            for layer, window in zip(group.layers, windows):
                h, _, a = layer(h, q_pos, window=window, mode="train")
                aux = aux + a
            return h, aux
        body = remat_wrap(group_body, self.cfg)
        for group in self.blocks:
            h, aux = body(group, h, aux)
        return h, None, aux

    def forward(self, tokens, *, prefix_embeds=None, mode: str = "prefill",
                cache: Optional[Cache] = None,
                decode_pos: Optional[int] = None):
        """tokens (B, S) int; ``prefix_embeds`` (B, P, d) (a vision
        frontend's patch embeddings, any float dtype) go before the tokens,
        through ``vision_proj``. ``mode`` 'prefill', 'decode' or 'train'
        (:meth:`apply_decoder`). Returns (logits (B, P + S, V_padded) f32,
        cache, aux loss)."""
        h = self.embed_tokens(tokens)
        if prefix_embeds is not None:
            pe = prefix_embeds.to(h.dtype)
            if hasattr(self, "vision_proj"):
                pe = self.vision_proj(pe)
            h = torch.cat([pe, h], dim=1)
        b, s = h.shape[:2]
        if mode == "decode":
            q_pos = torch.full((b, s), decode_pos, dtype=torch.int64,
                               device=h.device)
        else:
            q_pos = torch.arange(s, device=h.device)[None].expand(b, s)
        h, cache, aux = self.apply_decoder(h, q_pos, mode=mode, cache=cache,
                                           decode_pos=decode_pos)
        return self.logits(self.final_norm(h)), cache, aux


def cross_entropy(logits, labels, vocab_size: int):
    """Mean cross-entropy over the positions whose label is >= 0: the
    logsumexp over the first ``vocab_size`` columns (the rest are the
    vocabulary's padding), less the label's logit. logits (..., V_padded)
    f32; labels (...) int."""
    lse = torch.logsumexp(logits[..., :vocab_size], dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = (lse - gold) * mask
    return ce.sum() / mask.sum().clamp_min(1.0)


def train_loss(model: Transformer, batch):
    """JAX's ``train_loss``: the cross-entropy of the token positions (a
    vision prefix's positions dropped) against ``batch['labels']``, plus
    ``router_aux_weight`` times the MoE layers' aux loss."""
    logits, _, aux = model(batch["tokens"],
                           prefix_embeds=batch.get("prefix_embeds"),
                           mode="train")
    s_tok = batch["tokens"].shape[1]
    loss = cross_entropy(logits[:, -s_tok:], batch["labels"],
                         model.cfg.vocab_size)
    if model.cfg.moe is not None:
        loss = loss + model.cfg.moe.router_aux_weight * aux
    return loss


def init(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights in ``cfg.dtype``, drawn on ``device`` (default: the
    card) from a generator on that device seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, generator=gen, device=dev)
