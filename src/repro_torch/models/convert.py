"""Load a JAX MeshGraphNet param pytree into a :class:`MeshGraphNet`.

The pytree arrives as numpy arrays (nested dicts and lists, as
``repro.models.meshgraphnet.init`` builds it). Its ``proc_edge`` and
``proc_node`` leaves carry a leading ``n_mp_layers`` axis, which is unstacked
into the module list. Any missing or extra key, and any shape mismatch,
raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve
from repro_torch.models.meshgraphnet import MeshGraphNet

_STACKED = ("proc_edge", "proc_node")


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def state_dict_from_jax(tree, n_mp_layers: int) -> Dict[str, torch.Tensor]:
    """Flatten the pytree into ``MeshGraphNet.state_dict()`` keys."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict param tree, got {type(tree)}")
    flat: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name not in _STACKED:
            _flatten(sub, f"{name}.", flat)
            continue
        stacked: Dict[str, np.ndarray] = {}
        _flatten(sub, "", stacked)
        for key, arr in stacked.items():
            if arr.ndim == 0 or arr.shape[0] != n_mp_layers:
                raise ValueError(f"{name}.{key}: leading axis "
                                 f"{arr.shape[:1]} != n_mp_layers "
                                 f"{n_mp_layers}")
            for i in range(n_mp_layers):
                flat[f"{name}.{i}.{key}"] = arr[i]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in flat.items()}


def params_from_jax(tree, cfg: GNNConfig, device=None) -> MeshGraphNet:
    """A :class:`MeshGraphNet` holding the JAX params (default device: the
    card)."""
    model = MeshGraphNet(cfg)
    want = model.state_dict()
    got = state_dict_from_jax(tree, cfg.n_mp_layers)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"param tree does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    bad = [f"{k}: {tuple(got[k].shape)} != {tuple(want[k].shape)}"
           for k in want if got[k].shape != want[k].shape]
    if bad:
        raise ValueError("param shape mismatch: " + "; ".join(bad))
    model.load_state_dict(got, strict=True)
    return model.to(resolve(device))
