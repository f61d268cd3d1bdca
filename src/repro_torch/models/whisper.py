"""Whisper's encoder-decoder transformer (the audio backbone; the mel and
conv frontend is stubbed: the caller supplies frame embeddings).

Port of ``repro.models.whisper``: a bidirectional encoder over the frames
(sinusoidal positions, LayerNorm, self-attention, the plain biased GELU
FFN), then a causal decoder whose layers add a cross-attention (``ln_x``,
``xattn``: q from the decoder, k and v from the encoder's output) between
self-attention and the FFN. Parameters are ``nn.Module``s named as the JAX
pytree, with ``enc_blocks[i]`` and ``dec_blocks[i]`` for its stacked
``enc_blocks`` and ``dec_blocks`` (``models.convert.whisper_from_jax``).

Every prefill attention goes through ``kernels.flash_attention.ops.mha``:
the encoder's and the cross-attention with ``causal=False`` (the cross with
Skv = the frames, Sq = the prompt), the decoder's self-attention causal.
Decode attention is the plain ``transformer.attend``, as for the decoders:
the self cache up to ``decode_pos`` (written in place) and the cross cache
at every frame. The layer stacks are Python loops (the JAX ``lax.scan``).
In training (:func:`train_loss`) every attention is the plain
``transformer.attend`` on both devices (the encoder's and the cross
non-causal, the decoder's causal), never the kernel, and with
``cfg.remat == "full"`` each encoder and decoder layer runs under
``transformer.remat_wrap``, as JAX wraps its scanned layer bodies.
The attention sublayers are marked for ``torch.profiler``
(spans, ``telemetry.span``: ``whisper.encoder_attention``,
``whisper.decoder_attention``, ``whisper.cross_attention``, each with its
projections), so a profile can split a prefill's device time among them.

JAX promotes a product of f32 frames and bf16 weights to f32; PyTorch
refuses mixed-dtype products, so ``encode`` adds the sinusoids in the
frames' dtype (as JAX does) and then casts to the weights' dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import transformer as tfm
from repro_torch.models.nn import Dense, Embed, LayerNorm
from repro_torch.telemetry import span

Cache = Dict[str, torch.Tensor]


def sinusoids(length: int, channels: int):
    """(length, channels) float32: sin then cos of position times
    ``exp(-log(10000) / (channels / 2 - 1) * i)``. Computed on the CPU, so
    the card and the CPU see the same table (their sin and exp may differ by
    an ulp, which the angle, up to 1,499 rad, would carry to 1e-4)."""
    lt = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-lt * torch.arange(channels // 2, dtype=torch.float32))
    ang = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, **init):
        super().__init__()
        dd = {k: v for k, v in init.items() if k != "generator"}
        self.ln1 = LayerNorm(cfg.d_model, **dd)
        self.attn = tfm.Attention(cfg, **init)
        self.ln2 = LayerNorm(cfg.d_model, **dd)
        self.mlp = tfm.FFN(cfg, **init)

    def forward(self, h, q_pos, mode: str = "prefill"):
        """One bidirectional layer; ``mode`` 'prefill' (the kernel) or
        'train' (the plain attention)."""
        with span("whisper.encoder_attention"):
            a, _ = self.attn(self.ln1(h), q_pos, window=None, mode=mode,
                             causal=False)
        h = h + a
        return h + self.mlp(self.ln2(h))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, **init):
        super().__init__()
        dd = {k: v for k, v in init.items() if k != "generator"}
        self.ln1 = LayerNorm(cfg.d_model, **dd)
        self.attn = tfm.Attention(cfg, **init)
        self.ln_x = LayerNorm(cfg.d_model, **dd)
        self.xattn = tfm.Attention(cfg, **init)
        self.ln2 = LayerNorm(cfg.d_model, **dd)
        self.mlp = tfm.FFN(cfg, **init)

    def cross_kv(self, enc_out):
        """The cross-attention's k, v (B, T, KV, hd) of the encoder's
        output."""
        cfg = self.xattn.cfg
        b, t, _ = enc_out.shape
        shape = (b, t, cfg.n_kv_heads, cfg.resolved_head_dim)
        return (self.xattn.wk(enc_out).reshape(shape),
                self.xattn.wv(enc_out).reshape(shape))

    def cross_attend(self, x, xk, xv, *, plain: bool):
        """q from the decoder's x (B, S, d); no mask (JAX's ``q_pos`` zeros
        against every frame). Prefill: the flash kernel, Skv = T; decode
        and training (``plain``): the plain ``attend``."""
        cfg = self.xattn.cfg
        b, s, _ = x.shape
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        with span("whisper.cross_attention"):
            q = tfm.split_heads(self.xattn.wq(x), h, hd)
            if plain:
                t = xk.shape[1]
                out = tfm.attend(
                    q, xk, xv, torch.zeros((b, s), dtype=torch.int64,
                                           device=x.device),
                    torch.arange(t, device=x.device)[None].expand(b, t),
                    window=None, cap=None)
            else:
                out = fa_ops.mha(q, xk, xv, causal=False)
            return self.xattn.wo(out.reshape(b, s, h * hd))

    def forward(self, h, q_pos, enc_out):
        """One layer in training: causal self-attention, cross-attention
        over ``enc_out``, the FFN; no cache."""
        with span("whisper.decoder_attention"):
            a, _ = self.attn(self.ln1(h), q_pos, window=None, mode="train")
        h = h + a
        with span("whisper.cross_attention"):
            xk, xv = self.cross_kv(enc_out)
        h = h + self.cross_attend(self.ln_x(h), xk, xv, plain=True)
        return h + self.mlp(self.ln2(h))


def empty_cache(cfg: ModelConfig, batch: int, seq_len: int, t_audio: int,
                dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Zero cache ``{'k', 'v'}`` (L, B, seq_len, KV, hd) for self-attention
    and ``{'xk', 'xv'}`` (L, B, t_audio, KV, hd) for the cross-attention,
    bf16 as JAX's."""
    tail = (cfg.n_kv_heads, cfg.resolved_head_dim)

    def z(s):
        return torch.zeros((cfg.n_layers, batch, s) + tail, dtype=dtype,
                           device=device)
    return {"k": z(seq_len), "v": z(seq_len), "xk": z(t_audio),
            "xv": z(t_audio)}


class Whisper(nn.Module):
    """``embed``, ``enc_blocks[i]``, ``enc_ln``, ``dec_blocks[i]``,
    ``dec_ln``, ``lm_head``, as the JAX pytree."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        init = dict(generator=generator, device=device,
                    dtype=dtype or getattr(torch, cfg.dtype))
        dd = {k: v for k, v in init.items() if k != "generator"}
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, **init)
        self.enc_blocks = nn.ModuleList(EncoderLayer(cfg, **init)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln = LayerNorm(cfg.d_model, **dd)
        self.dec_blocks = nn.ModuleList(DecoderLayer(cfg, **init)
                                        for _ in range(cfg.n_layers))
        self.dec_ln = LayerNorm(cfg.d_model, **dd)
        self.lm_head = Dense(cfg.d_model, cfg.padded_vocab, use_bias=False,
                             **init)

    def encode(self, audio_embeds, mode: str = "prefill"):
        """audio_embeds (B, T, d), the stubbed frontend's output, any float
        dtype -> (B, T, d) in the weights' dtype. ``mode`` 'prefill' (the
        kernel) or 'train' (the plain attention, each layer through
        ``remat_wrap``)."""
        b, t, d = audio_embeds.shape
        h = audio_embeds + sinusoids(t, d).to(audio_embeds.device,
                                              audio_embeds.dtype)[None]
        h = h.to(self.enc_ln.scale.dtype)
        q_pos = torch.arange(t, device=h.device)[None].expand(b, t)
        body = tfm.remat_wrap(EncoderLayer.forward, self.cfg) \
            if mode == "train" else EncoderLayer.forward
        for layer in self.enc_blocks:
            h = body(layer, h, q_pos, mode)
        return self.enc_ln(h)

    def decode_stack(self, tokens, cache: Optional[Cache] = None, *,
                     mode: str, decode_pos: Optional[int] = None,
                     enc_out=None):
        """The decoder over tokens (B, S). 'prefill' builds the cross K/V
        from ``enc_out`` and returns a new cache in the weights' dtype;
        'decode' reads them from ``cache`` and writes the self cache at
        ``decode_pos`` in place; 'train' runs each layer's plain attentions
        over ``enc_out`` through ``remat_wrap`` and keeps no cache (None).
        Returns (logits (B, S, V_padded) f32, cache)."""
        cfg = self.cfg
        h = self.embed(tokens)
        b, s = tokens.shape
        if mode == "decode":
            # JAX takes the row from a table as long as the cache; a row
            # does not depend on the table's length
            if not 0 <= decode_pos < cache["k"].shape[2]:
                raise ValueError(f"decode_pos {decode_pos} outside the "
                                 f"cache of {cache['k'].shape[2]} slots")
            pe = sinusoids(decode_pos + 1, cfg.d_model)[decode_pos]
            h = h + pe.to(h.device, h.dtype)[None, None, :]
            q_pos = torch.full((b, s), decode_pos, dtype=torch.int64,
                               device=h.device)
        elif mode == "prefill":
            h = h + sinusoids(s, cfg.d_model).to(h.device, h.dtype)[None]
            q_pos = torch.arange(s, device=h.device)[None].expand(b, s)
            t = enc_out.shape[1]
            cache = empty_cache(cfg, b, s, t, dtype=h.dtype, device=h.device)
        elif mode == "train":
            h = h + sinusoids(s, cfg.d_model).to(h.device, h.dtype)[None]
            q_pos = torch.arange(s, device=h.device)[None].expand(b, s)
            body = tfm.remat_wrap(DecoderLayer.forward, cfg)
            for layer in self.dec_blocks:
                h = body(layer, h, q_pos, enc_out)
            h = self.dec_ln(h)
            return (h @ self.lm_head.w).float(), None
        else:
            raise ValueError(f"mode must be 'prefill', 'decode' or 'train', "
                             f"got {mode!r}")
        for i, layer in enumerate(self.dec_blocks):
            ckv = (cache["k"][i], cache["v"][i]) if mode == "decode" \
                else None
            with span("whisper.decoder_attention"):
                a, (k, v) = layer.attn(layer.ln1(h), q_pos, window=None,
                                       mode=mode, cache_kv=ckv,
                                       decode_pos=decode_pos)
            h = h + a
            if mode == "decode":
                xk, xv = cache["xk"][i], cache["xv"][i]
            else:
                with span("whisper.cross_attention"):
                    xk, xv = layer.cross_kv(enc_out)
                cache["k"][i], cache["v"][i] = k, v
                cache["xk"][i], cache["xv"][i] = xk, xv
            h = h + layer.cross_attend(layer.ln_x(h), xk, xv,
                                       plain=mode == "decode")
            h = h + layer.mlp(layer.ln2(h))
        h = self.dec_ln(h)
        return (h @ self.lm_head.w).float(), cache


def train_loss(model: Whisper, batch):
    """JAX's whisper ``train_loss``: the encoder over
    ``batch['audio_embeds']``, the decoder over ``batch['tokens']``, the
    cross-entropy against ``batch['labels']``."""
    enc_out = model.encode(batch["audio_embeds"], mode="train")
    logits, _ = model.decode_stack(batch["tokens"], mode="train",
                                   enc_out=enc_out)
    return tfm.cross_entropy(logits, batch["labels"], model.cfg.vocab_size)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> Whisper:
    """Random weights in ``cfg.dtype``, drawn on ``device`` (default: the
    card) from a generator on that device seeded with ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Whisper(cfg, generator=gen, device=dev)
