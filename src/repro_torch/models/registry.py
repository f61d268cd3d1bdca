"""Model API over the LLM families the port runs: so far the dense decoder.

``get_model(cfg)`` returns a :class:`ModelAPI`, the counterpart of
``repro.models.registry._decoder_api``:
  init(seed=0, device=None) -> params (a ``Transformer``)
  prefill(params, batch) -> (logits, cache)
  decode(params, cache, batch, pos) -> (logits, cache)   cache updated in place
  empty_cache(batch, seq_len, device=None) -> {'k', 'v'} zeros, bf16
``batch`` holds ``tokens`` (B, S) int on the params' device. ``train_loss``
comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tfm


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
        return params(batch["tokens"], mode="prefill")

    @torch.no_grad()
    def decode(params, cache, batch, pos: int):
        return params(batch["tokens"], mode="decode", cache=cache,
                      decode_pos=int(pos))

    def empty_cache(batch: int, seq_len: int, device=None):
        return tfm.empty_cache(cfg, batch, seq_len, device=resolve(device))

    return ModelAPI(cfg, init, prefill, decode, empty_cache)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port runs the dense decoder only; family {cfg.family!r} "
            "(encoder-decoder, SSM, hybrid, MoE, vision) is still to port, "
            "see ROADMAP.md")
    return _decoder_api(cfg)
