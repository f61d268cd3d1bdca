"""Config registry of the port: the paper's two models (X-MeshGraphNet and
X-UNet3D) and every LLM config of the JAX package: the decoders (dense, MoE
and pixtral's with its stubbed vision prefix), whisper's encoder-decoder,
the xLSTM and zamba2's hybrid of Mamba2 blocks and a shared attention
block. ``SHAPES`` are the four input shapes of the dry run and the cost
model, as ``repro.configs.SHAPES``."""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.configs.base import (GNNConfig, HardwareSpec, HW,  # noqa: F401
                                      ModelConfig, SHAPES, ShapeConfig,
                                      UNetConfig)

# in the order of ``repro.configs._ARCH_MODULES``
_ARCH_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "pixtral-12b": "pixtral_12b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-3-8b": "granite_3_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "yi-34b": "yi_34b",
    "gemma2-9b": "gemma2_9b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "xmgn-drivaer": "xmgn_drivaer",
    "xunet3d-drivaer": "xunet3d_drivaer",
}

# the LLM configs, in the order of ``repro.configs.ASSIGNED_ARCHS``
ASSIGNED_ARCHS = [k for k in _ARCH_MODULES
                  if k not in ("xmgn-drivaer", "xunet3d-drivaer")]


def get_config(name: str) -> Union[GNNConfig, ModelConfig, UNetConfig]:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown config {name!r}; the port knows "
            f"{sorted(_ARCH_MODULES)}, the configs of "
            "repro.configs._ARCH_MODULES (src/repro/configs/__init__.py)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def list_configs() -> dict:
    """Every config the port knows, by name, in JAX's order."""
    return {name: get_config(name) for name in _ARCH_MODULES}
