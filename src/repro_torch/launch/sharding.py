"""Process groups and partition placement for multi-process GNN training.

Port of the GNN helpers of ``repro.launch.sharding``. Where the JAX package
runs one process over a 1-axis device mesh, the port runs one process per
rank under ``torch.distributed``:

* :func:`shard_count_for` is JAX's rule: the largest rank count that
  divides the partition count (P = 21 on 8 ranks trains 7-way);
* :func:`init_process_group` takes the place of ``mesh_for_shards``: it
  joins this process to a group of ``world_size`` ranks;
* :func:`rank_device` maps a local rank to its card;
* :func:`shard_put` is the rank's part of ``shard_put``: rank r takes
  partitions ``[r P / n, (r + 1) P / n)`` of a stacked (P, ...) batch, as
  ``PartitionSpec(axis)`` places them; a rank at or past ``n`` takes none.

The LLM rules of that module are copied rule for rule: a parameter's JAX
key string (``"['blocks']['attn']['wq']['w']"``) is matched against the
same regexes, with the same fallbacks (an axis that does not divide its
dimension is dropped, tensors under 2**16 elements replicate), giving the
same specs. A spec is a :class:`Spec`, a tuple of a mesh-axis name, a
tuple of names or ``None`` per dimension (``PartitionSpec``'s stand-in).
The rules read a mesh's axis names and sizes only, from a
``DeviceMesh`` or a :class:`MeshShape`. Where JAX stacks a subtree on a
leading group axis (``blocks``, whisper's ``enc_blocks``/``dec_blocks``),
the port holds one tensor a group, which takes JAX's spec without its
leading ``None`` (:func:`param_specs`). :func:`param_shardings` turns the
specs into ``DTensor`` placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=120)


def shard_count_for(n_items: int, world: int,
                    limit: Optional[int] = None) -> int:
    """Largest rank count, at most ``world`` (and ``limit``), that divides
    ``n_items``. ``limit=1`` puts every partition on rank 0."""
    n = world if limit is None else min(world, max(int(limit), 1))
    d = max(min(n, n_items), 1)
    while n_items % d:
        d -= 1
    return d


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       backend: Optional[str] = None, device="cuda",
                       timeout: timedelta = DEFAULT_TIMEOUT):
    """Join this process to the default group as ``rank`` of
    ``world_size`` and return the group. ``backend`` defaults to ``nccl``
    for a ``cuda`` device and ``gloo`` for the CPU; ``init_method`` is a
    ``file://`` or ``tcp://`` address (``env://`` under ``torchrun``).
    ``timeout`` bounds the rendezvous and every collective."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dist.group.WORLD


def rank_device(local_rank: int) -> torch.device:
    """The card of local rank ``local_rank``: ranks past the card count
    share cards in turn."""
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: CUDA is not available; run the "
                           "ranks on the CPU with device='cpu'")
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def shard_range(n_items: int, rank: int, n_shards: int) -> range:
    """The partitions of ``rank`` when ``n_shards`` ranks split
    ``n_items`` evenly (empty for a rank at or past ``n_shards``)."""
    if n_items % n_shards:
        raise ValueError(f"{n_items} partitions do not split over "
                         f"{n_shards} ranks")
    per = n_items // n_shards
    if rank >= n_shards:
        return range(0)
    return range(rank * per, (rank + 1) * per)


def shard_put(batch: dict, rank: int, n_shards: int,
              device: Union[str, torch.device]) -> dict:
    """Rank ``rank``'s slice of a stacked (P, ...) batch of numpy arrays,
    as tensors on ``device``."""
    n_items = next(iter(batch.values())).shape[0]
    part = shard_range(n_items, rank, n_shards)
    dev = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[part.start:part.stop])).to(dev) for k, v in batch.items()}


# --------------------------------------------------------------------------
# The LLM rules: parameter, optimizer-state, batch and cache specs.
# --------------------------------------------------------------------------


class Spec(tuple):
    """A partition spec: per tensor dimension a mesh-axis name, a tuple of
    names (the dimension split over each, major first) or ``None``;
    dimensions past its length are replicated. ``Spec()`` replicates. A
    tuple of one name is that name, as ``PartitionSpec`` has it."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: what the rules read
    (``.axis_names`` and ``.shape[name]``, as of a JAX ``Mesh``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (a ``MeshShape`` or any
    object with ``axis_names`` and a ``shape`` mapping passes through)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return MeshShape(tuple(mesh.axis_names),
                         tuple(mesh.shape[a] for a in mesh.axis_names))
    return MeshShape(tuple(names),
                     tuple(mesh.size(i) for i in range(len(names))))


def _axis_size(mesh, name) -> int:
    ms = mesh_shape(mesh)
    return ms.shape[name] if name in ms.axis_names else 0


def data_axes(mesh) -> tuple:
    """The batch axes of a mesh: ``('pod', 'data')`` when multi-pod."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _fit(spec: Spec, shape, mesh) -> Spec:
    """Drop spec axes that don't divide the corresponding dim."""
    out = []
    pad = (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, tuple(spec) + pad):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= max(_axis_size(mesh, a), 1)
        ok = all(_axis_size(mesh, a) > 0 for a in axes) and dim % size == 0
        out.append(ax if ok else None)
    return Spec(*out)


# (regex on the JAX key string, tp spec, fsdp_tp spec): first match wins.
# Embeddings and the LM head shard the vocabulary on 'model' only, even
# under FSDP (their d_model dim on 'data' would meet batch-on-'data'
# activations at the embed and logits boundaries).
_RULES = [
    (r"embed.*table", Spec("model", None), Spec("model", None)),
    (r"lm_head.*w$", Spec(None, "model"), Spec(None, "model")),
    (r"vision_proj.*w$", Spec(None, "model"), Spec("data", "model")),
    (r"(wq|wk|wv|w_gate|w_up|up_proj|in_proj|w_in|w_z|w_i|w_f|w_o)\]\['w",
     Spec(None, "model"), Spec("data", "model")),
    (r"(wo|w_down|down_proj|out_proj|w_out)\]\['w",
     Spec("model", None), Spec("model", "data")),
    (r"router", Spec(None, None), Spec(None, None)),
    # MoE expert weights (E, d, ff) / (E, ff, d): expert-parallel on 'model'
    (r"moe.*w_(gate|up)$", Spec("model", None, None),
     Spec("model", "data", None)),
    (r"moe.*w_down$", Spec("model", None, None), Spec("model", None, "data")),
    (r"shared.*w_(gate|up)$", Spec(None, "model"), Spec("data", "model")),
    (r"shared.*w_down$", Spec("model", None), Spec("model", "data")),
    (r"conv_w", Spec(None, "model"), Spec(None, "model")),
    (r"R$", Spec(None, None, None, None), Spec(None, None, None, None)),
]


def _spec_for_path(path_str: str, shape, mesh, mode: str) -> Spec:
    if mode == "dp":
        return Spec()     # pure data parallelism: replicate all params
    for pat, tp_spec, fsdp_spec in _RULES:
        if re.search(pat, path_str):
            spec = fsdp_spec if mode == "fsdp_tp" else tp_spec
            return _fit(spec, shape, mesh)
    if len(shape) >= 2:
        # default for unmatched matrices: shard last dim on model
        return _fit(Spec(*([None] * (len(shape) - 1) + ["model"])), shape,
                    mesh)
    return Spec()


# the subtrees the JAX package stacks on a leading group (layer) axis
_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def jax_key(name: str) -> Tuple[str, bool]:
    """The JAX key string of a port parameter name, and whether the
    parameter is one group's tensor of a stacked JAX leaf:
    ``blocks.3.layers.1.attn.wq.w`` -> (``"['blocks']['layers'][1]['attn']
    ['wq']['w']"``, True)."""
    parts = name.split(".")
    per_group = parts[0] in _STACKED
    if per_group:
        parts = [parts[0], *parts[2:]]
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in parts), per_group


def param_spec(name: str, shape, mesh, mode: str) -> Spec:
    """The spec of one parameter (port name, port shape), JAX's rule for its
    leaf: a stacked leaf (``blocks``, ``first_layers``) takes its inner
    shape's spec behind a ``None``, which a per-group tensor drops."""
    pstr, per_group = jax_key(name)
    shape = tuple(shape)
    jshape = (1,) + shape if per_group else shape
    stacked = "blocks" in pstr or "first_layers" in pstr
    inner_shape = jshape[1:] if stacked else jshape
    inner_size = 1
    for d in inner_shape:
        inner_size *= d
    if inner_size < 2 ** 16:
        # tiny tensors (gates, norms, biases): replicate
        spec = Spec()
    elif stacked:
        spec = Spec(None, *_spec_for_path(pstr, inner_shape, mesh, mode))
    else:
        spec = _spec_for_path(pstr, jshape, mesh, mode)
    if per_group and len(spec):
        spec = Spec(*spec[1:])
    return spec


def param_specs(model, cfg, mesh, mode: Optional[str] = None
                ) -> Dict[str, Spec]:
    """``{name: Spec}`` of ``model``'s parameters (any device, ``meta``
    included) under ``mode`` (default ``cfg.param_sharding``)."""
    mode = mode or cfg.param_sharding
    return {name: param_spec(name, p.shape, mesh, mode)
            for name, p in model.named_parameters()}


def placements(spec: Spec, mesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh``: mesh axis ``a`` is
    ``Shard(d)`` if tensor dim ``d`` names it (a tuple on one dim shards it
    on each of its axes, major first), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in mesh_shape(mesh).axis_names:
        dim = None
        for d, ax in enumerate(spec):
            if ax == a or (isinstance(ax, tuple) and a in ax):
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def param_shardings(model, cfg, mesh, mode: Optional[str] = None
                    ) -> Dict[str, list]:
    """``{name: placements}`` of ``model``'s parameters on a
    ``DeviceMesh``."""
    return {name: placements(spec, mesh)
            for name, spec in param_specs(model, cfg, mesh, mode).items()}


def optimizer_state_specs(shapes: Dict[str, tuple], pspecs: Dict[str, Spec],
                          mesh) -> Dict[str, Spec]:
    """ZeRO-1: Adam m/v sharded over 'data' on top of the param specs, on
    the first dimension that is unsharded and divisible. ``shapes`` and
    ``pspecs`` are keyed alike (the result too). A per-group tensor of a
    stacked JAX leaf has no group dimension, so where JAX's leaf takes
    'data' on its group axis (48 groups of qwen3-moe, 32 layers of
    whisper) the port's tensor takes it on its own first free dimension
    that divides: the same bytes a device."""
    dsize = _axis_size(mesh, "data")

    def one(shape, spec):
        if dsize <= 1:
            return spec
        used = [a for ax in tuple(spec) if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if "data" in used:
            return spec
        dims = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
        for i, (d, ax) in enumerate(zip(shape, dims)):
            if ax is None and d % dsize == 0 and d >= dsize:
                dims[i] = "data"
                return Spec(*dims)
        return spec

    return {k: one(tuple(shapes[k]), pspecs[k]) for k in pspecs}


def batch_specs(cfg, shape, mesh, mode: Optional[str] = None) -> dict:
    dp = data_axes(mesh)
    mode = mode or cfg.param_sharding
    names = mesh_shape(mesh).axis_names
    if mode == "dp":
        # pure data parallelism: the 'model' axis carries no params, so the
        # batch goes on it too
        dp = dp + tuple(a for a in ("model",) if a in names)
    ndp = 1
    for a in dp:
        ndp *= _axis_size(mesh, a)
    bspec = dp if (shape.global_batch % max(ndp, 1) == 0 and ndp > 1) \
        else None
    out = {"tokens": Spec(bspec, None), "labels": Spec(bspec, None)}
    if cfg.frontend in ("vision", "audio"):
        key = "prefix_embeds" if cfg.frontend == "vision" else "audio_embeds"
        out[key] = Spec(bspec, None, None)
    if shape.kind != "train":
        out.pop("labels")
    return out


def cache_seq_axes(shape, mesh) -> tuple:
    """How to shard the KV-cache sequence dim: 'model' normally; for batch-1
    long-context decode, both ('data','model')."""
    names = mesh_shape(mesh).axis_names
    if shape.global_batch == 1:
        return tuple(a for a in ("data", "model") if a in names)
    return ("model",) if "model" in names else ()


def cache_specs(cfg, shape, mesh, cache: dict) -> Dict[str, Spec]:
    """Specs of a decode cache or recurrent state (``{name: tensor}``; the
    port's leaves have the JAX leaves' shapes, group axis included).

    By shape: the first dim equal to ``shape.seq_len`` is sharded per
    :func:`cache_seq_axes`; a dim equal to the global batch (before it) goes
    on the data axes."""
    del cfg
    dp = data_axes(mesh)
    ndp = 1
    for a in dp:
        ndp *= _axis_size(mesh, a)
    seq_ax = cache_seq_axes(shape, mesh)
    b = shape.global_batch

    def spec_of(leaf_shape):
        dims = []
        seq_done = False
        batch_done = False
        for d in leaf_shape:
            if d == shape.seq_len and seq_ax and not seq_done:
                dims.append(seq_ax if len(seq_ax) > 1 else seq_ax[0])
                seq_done = True
            elif (d == b and b % max(ndp, 1) == 0 and ndp > 1 and b > 1
                  and not batch_done and not seq_done):
                dims.append(dp if len(dp) > 1 else dp[0])
                batch_done = True
            else:
                dims.append(None)
        return _fit(Spec(*dims), leaf_shape, mesh)

    return {k: spec_of(tuple(t.shape)) for k, t in cache.items()}
