"""Model API over the LLM families the port runs: the decoders.

``get_model(cfg)`` returns a :class:`ModelAPI`, the counterpart of
``repro.models.registry._decoder_api``, for the ``dense``, ``moe`` and
``vlm`` families:
  init(seed=0, device=None) -> params (a ``Transformer``)
  prefill(params, batch) -> (logits, cache)
  decode(params, cache, batch, pos) -> (logits, cache)   cache updated in place
  empty_cache(batch, seq_len, device=None) -> zero KV cache, bf16
``batch`` holds ``tokens`` (B, S) int on the params' device and, for a
vision frontend, ``prefix_embeds`` (B, P, d). The MoE aux loss is dropped,
as serving drops it. ``train_loss`` comes with the training slice.
:func:`param_count` and :func:`active_param_count` count a config's
parameters without drawing them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tfm

DECODER_FAMILIES = ("dense", "moe", "vlm")


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode: Callable
    empty_cache: Callable


def _decoder_api(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return tfm.init(cfg, seed, device)

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

    return ModelAPI(cfg, init, prefill, decode, empty_cache)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"the port runs the decoder families {DECODER_FAMILIES}; family "
            f"{cfg.family!r} (encoder-decoder audio, SSM, hybrid) is still "
            "to port, see ROADMAP.md")
    return _decoder_api(cfg)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the config's model, counted on the ``meta`` device
    (nothing is drawn or allocated)."""
    get_model(cfg)
    model = tfm.Transformer(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())


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
