"""Load JAX param pytrees into the port's modules, and back.

A pytree arrives as numpy arrays (nested dicts and lists, as the JAX
package's ``init`` builds it). MeshGraphNet: its ``proc_edge`` and
``proc_node`` leaves carry a leading ``n_mp_layers`` axis, which is
unstacked into the module list (``params_to_jax`` restacks it). Decoder
transformer: its ``blocks`` leaves carry a leading group axis. Any missing
or extra key, and any shape mismatch, raises. A JAX ``AdamState`` loads into
the port's (``adam_state_from_jax``), its moments in the order of
``MeshGraphNet.leaves()``, and ``adam_state_to_jax`` writes it back.
Whisper (``whisper_from_jax``): its ``enc_blocks`` and ``dec_blocks``
stacks are unstacked into the layer lists; the xLSTM (``xlstm_from_jax``):
its ``blocks`` (groups, each a list of mLSTM blocks and an sLSTM block)
into ``blocks[g]``; the hybrid (``hybrid_from_jax``): its ``blocks``
(groups, each a list of Mamba2 blocks) into ``blocks[g].mamba[i]``, the one
``shared_attn`` layer by name.
:func:`llm_leaves` lists an LLM's parameters in the order of JAX's
``tree_leaves(params)``, which the LLM trainer's Adam and global norm
follow, as they follow ``MeshGraphNet.leaves()`` for the GNN.
X-UNet3D (``xunet_from_jax``, ``xunet_to_jax``): convolution weights go
from JAX's DHWIO ``(k, k, k, cin, cout)`` to PyTorch's OIDHW ``(cout, cin,
k, k, k)`` and back; without attention gates the tree's ``gates`` entries
are ``None``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ModelConfig, UNetConfig
from repro_torch.device import resolve
from repro_torch.models.meshgraphnet import MeshGraphNet
from repro_torch.models.stacks import (XLSTM, Hybrid, hybrid_group_layout,
                                      xlstm_group_layout)
from repro_torch.models.transformer import Transformer, group_structure
from repro_torch.models.whisper import Whisper
from repro_torch.models.xunet3d import XUNet3D, full_f32
from repro_torch.optim.adam import AdamState

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


def _unflatten(flat: Dict[str, np.ndarray]):
    """Dotted keys -> nested dicts; a dict whose keys are 0..n-1 -> list."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = arr

    def lists(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: lists(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(root)


def _restack(named: Dict[str, np.ndarray]) -> dict:
    """``MeshGraphNet`` parameter names -> the JAX pytree, with
    ``proc_edge``/``proc_node`` restacked on a leading ``n_mp_layers``
    axis (the layers come in order: ``named`` follows the model's)."""
    flat: Dict[str, np.ndarray] = {}
    stacked: Dict[str, list] = {}
    for name, arr in named.items():
        top, *rest = name.split(".")
        if top in _STACKED:
            stacked.setdefault(".".join([top, *rest[1:]]), []).append(arr)
        else:
            flat[name] = arr
    flat.update({k: np.stack(v) for k, v in stacked.items()})
    return _unflatten(flat)


def params_to_jax(model: MeshGraphNet, grads: bool = False) -> dict:
    """The inverse of :func:`params_from_jax`: the model's parameters, or
    with ``grads`` their ``.grad``, as the JAX pytree of numpy arrays, with
    ``proc_edge``/``proc_node`` restacked on a leading ``n_mp_layers``
    axis."""
    named: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        named[name] = t.detach().cpu().numpy()
    return _restack(named)


def _opt_field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def adam_state_from_jax(state, model: MeshGraphNet) -> AdamState:
    """A JAX ``AdamState`` (``step``, ``mu``, ``nu``; numpy trees), or the
    ``{"step", "mu", "nu"}`` dict a training checkpoint holds, as the
    port's, its moments in ``model.leaves()`` order on the model's
    device."""
    n = model.cfg.n_mp_layers
    mu = state_dict_from_jax(_opt_field(state, "mu"), n)
    nu = state_dict_from_jax(_opt_field(state, "nu"), n)
    names = [name for name, _ in model.leaves()]
    dev = next(model.parameters()).device
    if sorted(mu) != sorted(names) or sorted(nu) != sorted(names):
        raise KeyError("Adam state does not match the model's parameters")
    return AdamState(
        step=torch.tensor(int(np.asarray(_opt_field(state, "step"))),
                          dtype=torch.int32, device=dev),
        mu=[mu[k].to(dev) for k in names], nu=[nu[k].to(dev) for k in names])


def adam_state_to_jax(state: AdamState, model: MeshGraphNet) -> dict:
    """The inverse of :func:`adam_state_from_jax`: ``{"step": () int32,
    "mu": tree, "nu": tree}``, the moments as params-shaped numpy trees in
    the JAX layout (as :func:`params_to_jax` lays out the params), the
    layout of a training checkpoint's ``opt``."""
    names = [name for name, _ in model.leaves()]

    def tree(moments):
        return _restack({k: m.detach().cpu().numpy()
                         for k, m in zip(names, moments)})
    return {"step": np.asarray(int(state.step), np.int32),
            "mu": tree(state.mu), "nu": tree(state.nu)}


def _llm_from_jax(tree, cfg: ModelConfig, model: torch.nn.Module,
                  stacked: Dict[str, tuple], device) -> torch.nn.Module:
    """Load a JAX LLM pytree into ``model`` (built on ``meta``), each leaf
    in its parameter's dtype (``cfg.dtype``, or float32 where the model
    keeps one whatever the config: Mamba2's ``A_log``, ``dt_bias``,
    ``D``): each subtree named in ``stacked`` has a leading axis of
    ``(length, what it counts)``, split into ``{name}.{i}.``; the rest
    loads by name."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict param tree, got {type(tree)}")
    flat: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name not in stacked:
            _flatten(sub, f"{name}.", flat)
            continue
        n, what = stacked[name]
        leaves: Dict[str, np.ndarray] = {}
        _flatten(sub, "", leaves)
        for key, arr in leaves.items():
            if arr.ndim == 0 or arr.shape[0] != n:
                raise ValueError(f"{name}.{key}: leading axis "
                                 f"{arr.shape[:1]} != {n} {what}")
            for i in range(n):
                flat[f"{name}.{i}.{key}"] = arr[i]
    dtype = getattr(torch, cfg.dtype)
    want = model.state_dict()
    got = {k: torch.tensor(np.asarray(v, np.float32)).to(
        want[k].dtype if k in want else dtype) for k, v in flat.items()}
    _load(model, got, assign=True)
    return model.to(resolve(device))


def transformer_from_jax(tree, cfg: ModelConfig, device=None) -> Transformer:
    """A :class:`Transformer` holding a JAX decoder pytree (numpy arrays),
    in ``cfg.dtype`` (default device: the card). The ``blocks`` subtree,
    stacked on a leading group axis around a ``layers`` list, is split into
    ``blocks[g].layers[i]``; ``w`` stays (in, out). The rest loads by name:
    ``first_layers`` (a list), a layer's ``moe`` subtree (``router.w``, the
    (E, ., .) expert stacks, ``shared``) and ``vision_proj``."""
    _, n_groups, _ = group_structure(cfg)
    return _llm_from_jax(tree, cfg, Transformer(cfg, device="meta"),
                         {"blocks": (n_groups, "groups")}, device)


def whisper_from_jax(tree, cfg: ModelConfig, device=None) -> Whisper:
    """A :class:`Whisper` holding a JAX whisper pytree (numpy arrays), in
    ``cfg.dtype`` (default device: the card): ``enc_blocks`` and
    ``dec_blocks``, stacked on a leading layer axis, are split into the
    layer lists (a decoder layer's ``xattn`` and ``ln_x`` with it); the
    rest (``embed``, ``enc_ln``, ``dec_ln``, ``lm_head``) loads by name."""
    return _llm_from_jax(tree, cfg, Whisper(cfg, device="meta"),
                         {"enc_blocks": (cfg.encoder_layers, "layers"),
                          "dec_blocks": (cfg.n_layers, "layers")}, device)


def xlstm_from_jax(tree, cfg: ModelConfig, device=None) -> XLSTM:
    """An :class:`XLSTM` holding a JAX xLSTM pytree (numpy arrays), in
    ``cfg.dtype`` (default device: the card): ``blocks``, stacked on a
    leading group axis around ``{'mlstm': [...], 'slstm': {...}}``, is split
    into ``blocks[g].mlstm[i]`` and ``blocks[g].slstm``."""
    _, n_groups = xlstm_group_layout(cfg)
    return _llm_from_jax(tree, cfg, XLSTM(cfg, device="meta"),
                         {"blocks": (n_groups, "groups")}, device)


def hybrid_from_jax(tree, cfg: ModelConfig, device=None) -> Hybrid:
    """A :class:`Hybrid` holding a JAX zamba2-style pytree (numpy arrays),
    in ``cfg.dtype`` with Mamba2's ``A_log``, ``dt_bias`` and ``D`` in
    float32 (default device: the card): ``blocks``, stacked on a leading
    group axis around ``{'mamba': [...]}``, is split into
    ``blocks[g].mamba[i]``; the single ``shared_attn`` layer, ``embed``,
    ``final_norm`` and ``lm_head`` load by name."""
    _, n_groups = hybrid_group_layout(cfg)
    return _llm_from_jax(tree, cfg, Hybrid(cfg, device="meta"),
                         {"blocks": (n_groups, "groups")}, device)


def _stacked_names(model: torch.nn.Module) -> tuple:
    """The subtrees JAX stacks on a leading layer or group axis."""
    if isinstance(model, Whisper):
        return ("enc_blocks", "dec_blocks")
    if isinstance(model, (Transformer, XLSTM, Hybrid)):
        return ("blocks",)
    raise TypeError(f"not an LLM of the port: {type(model).__name__}")


def llm_leaves(model: torch.nn.Module):
    """``(name, parameter)`` of a :class:`Transformer`, :class:`Whisper`,
    :class:`XLSTM` or :class:`Hybrid` in the JAX pytree's leaf order: dict
    keys sorted at every level, list items in order, and a leaf of a
    stacked subtree (``blocks``; whisper's ``enc_blocks``, ``dec_blocks``)
    as its per-group (per-layer) tensors in group order."""
    stacked = _stacked_names(model)

    def key(name):
        parts = [int(p) if p.isdigit() else p for p in name.split(".")]
        if parts[0] in stacked:
            parts = [parts[0], *parts[2:], parts[1]]
        return parts
    return sorted(model.named_parameters(), key=lambda kv: key(kv[0]))


def xunet_from_jax(tree, cfg: UNetConfig, device=None) -> XUNet3D:
    """An :class:`XUNet3D` holding a JAX X-UNet3D pytree (numpy arrays;
    ``gates`` entries ``None`` without attention gates), on ``device``
    (default: the card, with TF32 off)."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict param tree, got {type(tree)}")
    gates = tree.get("gates") or []
    if any(g is None for g in gates):
        if not all(g is None for g in gates):
            raise ValueError("gates: some entries None, some not")
        tree = {k: v for k, v in tree.items() if k != "gates"}
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    got = {}
    for key, arr in flat.items():
        a = np.asarray(arr, np.float32)
        if a.ndim == 5:                       # DHWIO -> OIDHW
            a = a.transpose(4, 3, 0, 1, 2)
        got[key] = torch.tensor(np.ascontiguousarray(a))
    model = XUNet3D(cfg, generator=torch.Generator().manual_seed(0))
    _load(model, got)
    dev = resolve(device)
    full_f32(dev)
    return model.to(dev)


def xunet_to_jax(model: XUNet3D, grads: bool = False) -> dict:
    """The inverse of :func:`xunet_from_jax`: the parameters, or with
    ``grads`` their ``.grad``, as the JAX pytree of numpy arrays (DHWIO
    weights; ``gates`` a list of ``None`` without attention gates)."""
    flat: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        a = t.detach().cpu().numpy()
        flat[name] = a.transpose(2, 3, 4, 1, 0) if a.ndim == 5 else a
    tree = _unflatten(flat)
    if model.gates is None:
        tree["gates"] = [None] * len(model.ups)
    return tree
