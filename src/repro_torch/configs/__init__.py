"""Config registry of the port: the paper's two models (X-MeshGraphNet and
X-UNet3D) and the LLM configs it can run so far."""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.configs.base import GNNConfig, ModelConfig, UNetConfig

_ARCH_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "xmgn-drivaer": "xmgn_drivaer",
    "xunet3d-drivaer": "xunet3d_drivaer",
}


def get_config(name: str) -> Union[GNNConfig, ModelConfig, UNetConfig]:
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"the port has no config {name!r} yet; it knows "
            f"{sorted(_ARCH_MODULES)}. The JAX package's list is "
            "repro.configs._ARCH_MODULES (src/repro/configs/__init__.py); "
            "the others are still to port (ROADMAP.md)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
