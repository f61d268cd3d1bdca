"""Load JAX param pytrees into the port's modules.

A pytree arrives as numpy arrays (nested dicts and lists, as the JAX
package's ``init`` builds it). MeshGraphNet: its ``proc_edge`` and
``proc_node`` leaves carry a leading ``n_mp_layers`` axis, which is
unstacked into the module list. Decoder transformer: its ``blocks`` leaves
carry a leading group axis. Any missing or extra key, and any shape
mismatch, raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ModelConfig
from repro_torch.device import resolve
from repro_torch.models.meshgraphnet import MeshGraphNet
from repro_torch.models.transformer import Transformer, group_structure

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


def _load(model: torch.nn.Module, got: Dict[str, torch.Tensor], *,
          assign: bool = False):
    want = model.state_dict()
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"param tree does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    bad = [f"{k}: {tuple(got[k].shape)} != {tuple(want[k].shape)}"
           for k in want if got[k].shape != want[k].shape]
    if bad:
        raise ValueError("param shape mismatch: " + "; ".join(bad))
    model.load_state_dict(got, strict=True, assign=assign)


def params_from_jax(tree, cfg: GNNConfig, device=None) -> MeshGraphNet:
    """A :class:`MeshGraphNet` holding the JAX params (default device: the
    card)."""
    model = MeshGraphNet(cfg)
    _load(model, state_dict_from_jax(tree, cfg.n_mp_layers))
    return model.to(resolve(device))


def transformer_from_jax(tree, cfg: ModelConfig, device=None) -> Transformer:
    """A :class:`Transformer` holding a JAX decoder pytree (numpy arrays),
    in ``cfg.dtype`` (default device: the card). The ``blocks`` subtree,
    stacked on a leading group axis around a ``layers`` list, is split into
    ``blocks[g].layers[i]``; ``w`` stays (in, out)."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict param tree, got {type(tree)}")
    _, n_groups, _ = group_structure(cfg)
    flat: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name != "blocks":
            _flatten(sub, f"{name}.", flat)
            continue
        stacked: Dict[str, np.ndarray] = {}
        _flatten(sub, "", stacked)
        for key, arr in stacked.items():
            if arr.ndim == 0 or arr.shape[0] != n_groups:
                raise ValueError(f"blocks.{key}: leading axis "
                                 f"{arr.shape[:1]} != {n_groups} groups")
            for g in range(n_groups):
                flat[f"blocks.{g}.{key}"] = arr[g]
    dtype = getattr(torch, cfg.dtype)
    got = {k: torch.tensor(np.asarray(v, np.float32)).to(dtype)
           for k, v in flat.items()}
    model = Transformer(cfg, device="meta")     # no weights drawn
    _load(model, got, assign=True)
    return model.to(resolve(device))
