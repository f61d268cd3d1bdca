"""Model API over the LLM families the port runs.

``get_model(cfg)`` returns a :class:`ModelAPI`, dispatched as
``repro.models.registry.get_model``, by the config's fields: an
encoder-decoder (whisper), then a config with SSM blocks and a shared
attention block (zamba2's hybrid), then one with SSM blocks (the xLSTM
stack), else the decoders (``dense``, ``moe``, ``vlm``). Every LLM family
of the JAX package runs:
  init(seed=0, device=None) -> params (an ``nn.Module``)
  train_loss(params, batch) -> scalar f32 loss, with grad enabled
  prefill(params, batch) -> (logits, cache)
  decode(params, cache, batch, pos) -> (logits, cache)   cache updated in place
  empty_cache(batch, seq_len, device=None) -> zero KV cache (bf16),
      recurrent state, or the hybrid's recurrent state and KV caches
``batch`` holds ``tokens`` (B, S) int on the params' device and, for a
vision frontend, ``prefix_embeds`` (B, P, d), for an audio frontend
``audio_embeds`` (B, T, d), and for ``train_loss`` ``labels`` (B, S). The
MoE aux loss is dropped in serving, as JAX's serving drops it, and added to
the training loss. :func:`param_count` and
:func:`active_param_count` count a config's parameters without drawing
them, on :func:`meta_model`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import stacks
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whi


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode: Callable
    empty_cache: Callable


def _decoder_api(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return tfm.init(cfg, seed, device)

    @torch.enable_grad()
    def train_loss(params, batch):
        return tfm.train_loss(params, batch)

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache, _ = params(batch["tokens"],
                                  prefix_embeds=batch.get("prefix_embeds"),
                                  mode="prefill")
        return logits, cache

    @torch.no_grad()
    def decode(params, cache, batch, pos: int):
        logits, cache, _ = params(batch["tokens"], mode="decode",
                                  cache=cache, decode_pos=int(pos))
        return logits, cache

    def empty_cache(batch: int, seq_len: int, device=None):
        return tfm.empty_cache(cfg, batch, seq_len, device=resolve(device))

    return ModelAPI(cfg, init, train_loss, prefill, decode, empty_cache)


def _whisper_api(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return whi.init(cfg, seed, device)

    @torch.enable_grad()
    def train_loss(params, batch):
        return whi.train_loss(params, batch)

    @torch.no_grad()
    def prefill(params, batch):
        enc_out = params.encode(batch["audio_embeds"])
        return params.decode_stack(batch["tokens"], None, mode="prefill",
                                   enc_out=enc_out)

    @torch.no_grad()
    def decode(params, cache, batch, pos: int):
        return params.decode_stack(batch["tokens"], cache, mode="decode",
                                   decode_pos=int(pos))

    def empty_cache(batch: int, seq_len: int, device=None):
        return whi.empty_cache(cfg, batch, seq_len,
                               t_audio=cfg.n_frontend_tokens,
                               device=resolve(device))

    return ModelAPI(cfg, init, train_loss, prefill, decode, empty_cache)


def _xlstm_api(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return stacks.xlstm_init(cfg, seed, device)

    @torch.enable_grad()
    def train_loss(params, batch):
        logits, _ = params(batch["tokens"], mode="train")
        return tfm.cross_entropy(logits, batch["labels"], cfg.vocab_size)

    @torch.no_grad()
    def prefill(params, batch):
        return params(batch["tokens"])

    @torch.no_grad()
    def decode(params, state, batch, pos: int):
        del pos  # the recurrent state carries no position
        return params(batch["tokens"], state)

    def empty_cache(batch: int, seq_len: int, device=None):
        del seq_len  # O(1) state, whatever the length
        return stacks.xlstm_empty_state(cfg, batch, device=resolve(device))

    return ModelAPI(cfg, init, train_loss, prefill, decode, empty_cache)


def _hybrid_api(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return stacks.hybrid_init(cfg, seed, device)

    @torch.enable_grad()
    def train_loss(params, batch):
        logits, _ = params(batch["tokens"], mode="train")
        return tfm.cross_entropy(logits, batch["labels"], cfg.vocab_size)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        state = stacks.hybrid_empty_state(cfg, tokens.shape[0],
                                          tokens.shape[1],
                                          device=tokens.device)
        return params(tokens, state, mode="prefill")

    @torch.no_grad()
    def decode(params, state, batch, pos: int):
        return params(batch["tokens"], state, mode="decode",
                      decode_pos=int(pos))

    def empty_cache(batch: int, seq_len: int, device=None):
        return stacks.hybrid_empty_state(cfg, batch, seq_len,
                                         device=resolve(device))

    return ModelAPI(cfg, init, train_loss, prefill, decode, empty_cache)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encoder_decoder:
        return _whisper_api(cfg)
    if cfg.ssm is not None and cfg.attn_every:
        return _hybrid_api(cfg)
    if cfg.ssm is not None:
        return _xlstm_api(cfg)
    return _decoder_api(cfg)


def meta_model(cfg: ModelConfig):
    """The config's model on the ``meta`` device: shapes and dtypes, no
    memory."""
    if cfg.is_encoder_decoder:
        return whi.Whisper(cfg, device="meta")
    if cfg.ssm is not None and cfg.attn_every:
        return stacks.Hybrid(cfg, device="meta")
    if cfg.ssm is not None:
        return stacks.XLSTM(cfg, device="meta")
    return tfm.Transformer(cfg, device="meta")


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the config's model, counted on the ``meta`` device
    (nothing is drawn or allocated)."""
    return sum(p.numel() for p in meta_model(cfg).parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token uses: an MoE layer counts its top-k routed experts
    (and the shared ones), not all of them."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    gs, ng, _ = tfm.group_structure(cfg)
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    return total - ng * gs * (m.n_experts - m.top_k) * per_expert
