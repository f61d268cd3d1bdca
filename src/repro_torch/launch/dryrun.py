"""Multi-pod dry run + roofline extraction, in one process, with nothing
allocated.

Port of ``repro.launch.dryrun``. For each (arch x input shape x mesh) it
builds the model, places its parameters, Adam state, batch and cache by the
sharding rules (``launch.sharding``), runs ONE real step of the port's own
step functions (a training step with Adam, a prefill, or a one-token
decode), and records:

* memory        -- per device, from ``MemTracker`` (``memory``);
* collectives   -- per device, the result bytes of every collective the
  step issued, by kind (:class:`StepCounter`, ``collective_bytes``);
* FLOPs         -- per device, ``FlopCounterMode``'s formulas over the ops
  the device ran (``per_device.hlo_raw``, the counterpart of JAX's raw
  ``cost_analysis``);
* roofline      -- compute, memory and collective times at the card's
  constants (``configs.base.HW``), from the analytic cost model
  (``launch.costmodel``) and the counted collective bytes.

Where JAX forces 512 host devices and lowers a jitted program, the port
starts a process group of 512 ranks on the ``fake`` backend
(:func:`init_fake_world`, as torchtitan's memory estimation does), builds a
``DeviceMesh`` of (16, 16) or (2, 16, 16) over its first ranks, and runs
the step eagerly under ``FakeTensorMode``: tensors have shapes, dtypes and
devices but no memory, parameters are ``DTensor``s whose local shards are
rank 0's, and a collective does nothing. Every layer runs, so nothing
needs a loop multiplier. The step runs inside ``kernels._build.dry_run``, so
the kernels' wrappers take their plain versions: no kernel is launched, and a
prefill's memory counts the plain attention's (BH, Sq, Skv) scores, which
the card's flash kernel never holds. The mesh's device type is the card's
(``--device cuda``, the default) or the CPU's (``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.report
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import types
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.configs.base import HW, GNNConfig, ModelConfig, ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch import costmodel
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.models import registry
from repro_torch.models.convert import llm_leaves
from repro_torch.optim.adam import AdamConfig, AdamState, adam_update

WORLD = 512
DEFAULT_OUT = {False: "results/dryrun_torch_sp",
               True: "results/dryrun_torch_mp"}

# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def init_fake_world(world_size: int = WORLD):
    """Join this process to a ``fake`` process group of ``world_size`` ranks
    as rank 0 (a ``FakeStore``: no rendezvous, no other process), unless a
    group exists already. Returns the world size."""
    if not dist.is_initialized():
        # importing it registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
    return dist.get_world_size()


def _wrapped(fn, ctx):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with ctx():
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def fake_dtensor_fixes():
    """Two computations inside DTensor's sharding propagation run apart
    from the step while this is active, and DTensor is restored after:

    * the output metadata of an op, which DTensor computes by running the
      op on fake tensors of the GLOBAL shapes: under the step's modes those
      would count as a device's FLOPs and memory, so it runs with every
      mode unset (DTensor then brings its own fake mode);
    * a strided shard's offsets (a view that merges two sharded dims, as
      attention's head reshapes do), which DTensor builds as an index
      tensor and reads back: under ``FakeTensorMode`` it would be fake and
      unreadable, so it runs with the fake mode unset."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                _disable_current_modes),
               (pt._StridedShard, "local_shard_size_and_offset",
                unset_fake_temporarily)]
    saved = []
    for cls, name, ctx in patches:
        fn = cls.__dict__.get(name)
        if not isinstance(fn, types.FunctionType):
            # without the patch the counts would be wrong, not absent
            raise RuntimeError(
                f"dry run: torch {torch.__version__} has no method "
                f"{cls.__name__}.{name} to run apart from the step")
        saved.append((cls, name, fn, ctx))
    for cls, name, fn, ctx in saved:
        setattr(cls, name, _wrapped(fn, ctx))
    try:
        yield
    finally:
        for cls, name, fn, _ in saved:
            setattr(cls, name, fn)


def _placed(t, mesh, placements):
    """``t``, a plain tensor (whole on every device) or a ``DTensor``, as a
    ``DTensor`` on ``mesh`` with ``placements``. A plain tensor's local
    tensor is a view of it, and taking a shard of a whole tensor moves no
    bytes."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t


def shardwise(op, x, others=(), keep_dims=None, **kwargs):
    """``op(x, *others, **kwargs)`` of a ``DTensor`` ``x``, computed on each
    device's shard: for an op whose output row at a position of the dims in
    ``keep_dims`` (default: all) reads only the inputs' rows at that
    position, as an elementwise op or a search along the last dim. A mesh
    dim of ``x`` that holds a partial sum or shards another dim is gathered
    first, each of ``others`` (plain or ``DTensor``, of ``x``'s rank) is
    placed as ``x`` then is, and the result, of ``others[0]``'s shape
    (else ``x``'s), takes those placements. Splitting rows among devices
    changes no row, so the result is the op's, bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    keep = set(range(x.ndim)) if keep_dims is None else \
        {d % x.ndim for d in keep_dims}
    pl = [p if type(p) is Shard and p.dim in keep else Replicate()
          for p in x.placements]
    x = _placed(x, mesh, pl)
    rest = [_placed(t, mesh, pl) for t in others]
    out = op(x.to_local(), *(t.to_local() for t in rest), **kwargs)
    size = (rest[0] if rest else x).shape
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=size,
                              stride=_contiguous(size))


def view_gathers(size, new_size, placements, mesh_sizes) -> set:
    """The mesh dims a view from ``size`` to ``new_size`` cannot keep
    sharded, where eager ``DTensor`` refuses them ("Cannot flatten /
    unflatten unevenly sharded tensor") or, for a dim sharded over two mesh
    dims, gives the shard a wrong local shape: a dim sharded ``m`` ways is
    merged with the dims after it while ``m`` does not divide it, or is
    split while ``m`` does not divide the first piece (then its mesh dims
    from the first that breaks that are gathered). JAX's GSPMD gathers such
    a dim itself (whisper's 20 heads over 16 'model' shards; qwen3-moe's
    batch on 'data' and 'model', split into its 4 KV heads)."""
    from torch.distributed.tensor import Shard
    prefix, acc = set(), 1
    for d in new_size:
        prefix.add(acc)
        acc *= d
    prefix.add(acc)
    out = set()
    for d in {p.dim for p in placements if type(p) is Shard}:
        dims = [i for i, p in enumerate(placements)
                if type(p) is Shard and p.dim == d]
        lo = 1
        for x in size[:d]:
            lo *= x
        hi = lo * size[d]
        if hi not in prefix:
            # merged with the dims after it
            n = size[d]
        elif lo not in prefix:
            continue               # the last dim of a merge: DTensor keeps it
        else:
            # the new dims it becomes: itself, or a split sharded on the
            # first piece
            pieces, acc = [], 1
            for x in new_size:
                if lo <= acc < hi and x != 1:
                    pieces.append(x)
                acc *= x
            if len(pieces) <= 1:
                continue
            n = pieces[0]
        m = 1
        for j, i in enumerate(dims):
            m *= mesh_sizes[i]
            if n % m:
                out.update(dims[j:])
                break
    return out


def laid_out(t):
    """``t``, a ``DTensor``, with its local tensor laid out as its global
    strides say. DTensor takes an op's global strides from the op run on
    global shapes, while the device runs it on its shard, and at the
    shard's shape an op may lay its output out otherwise (a shard of one
    head, a size-1 dim that the global tensor does not have: the MoE's
    ``act(g) * u``, attention's gradients). A view is then decided on the
    global strides, and the shard cannot be viewed so. Such a tensor is
    copied contiguous, and its global strides made so."""
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    dims = [d for d in range(t.ndim) if local.shape[d] > 1]
    if sorted(dims, key=lambda d: -t.stride()[d]) == \
            sorted(dims, key=lambda d: -local.stride()[d]):
        return t
    return DTensor.from_local(local.contiguous(), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=_contiguous(t.shape))


class DTensorViewRules(TorchDispatchMode):
    """The dry run's rules for views of ``DTensor``s, where eager DTensor's
    view does not compute what the view computes: ``aten.view`` and
    ``aten._unsafe_view`` (a ``reshape``'s view, the views inside
    ``einsum``, ``matmul`` and their gradients) of a ``DTensor`` first
    gather the mesh dims of :func:`view_gathers` and lay the shard out as
    its global strides say (:func:`laid_out`). Both leave every value as
    it is. It runs under the step's :class:`StepCounter`, which counts the
    gathers."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        aten = torch.ops.aten
        if func in (aten.view.default, aten._unsafe_view.default) and \
                isinstance(args[0], DTensor) and not kwargs:
            x, size = args[0], tuple(args[1])
            if -1 in size:
                rest = 1
                for d in size:
                    rest *= d if d != -1 else 1
                size = tuple(x.numel() // rest if d == -1 else d
                             for d in size)
            mesh = x.device_mesh
            with torch.no_grad():
                bad = view_gathers(tuple(x.shape), size, x.placements,
                                   [mesh.size(i) for i in range(mesh.ndim)])
                if bad:
                    x = x.redistribute(mesh, [
                        Replicate() if i in bad else p
                        for i, p in enumerate(x.placements)])
                x = laid_out(x)
            return func(x, args[1])
        return func(*args, **kwargs)


class DTensorRules(TorchFunctionMode):
    """Where eager ``DTensor`` shards an op of the models otherwise than
    GSPMD would, or has no rule for it, the dry run's rule for it (the
    models themselves hold no ``DTensor`` code beyond
    ``models.nn.splittable`` and ``whole``). Each computes what the op
    computes (``tests/test_torch_dryrun_rules.py`` holds them to it):

    * a gather of one index a row along the last dim (the cross-entropy's
      label logit, the vocabulary sharded or a partial sum): DTensor's
      rule gives a masked partial sum that cannot be reduced on fake
      tensors, so it runs as a masked sum over that dim, which is exact
      (one nonzero term) and reduces the partial sums once;
    * ``F.embedding`` of a vocabulary-sharded table gives partial sums
      that DTensor reduces at their first use only, and the residual
      stream reads them twice: they are reduced once, here;
    * ``torch.searchsorted`` (the MoE dispatch's first slot of each
      expert) has no sharding strategy: it runs on each device's rows
      (:func:`shardwise`, the searched dim whole);
    * ``F.logsigmoid`` (the xLSTM gates; ``aten.log_sigmoid_forward``) has
      none either: elementwise, on each device's shard;
    * an in-place ``scatter_`` into a plain tensor (the MoE dispatch's
      trash-slot buffer, made by ``torch.zeros``) with a ``DTensor`` index
      or source: the buffer is whole on every device, so it is written as
      a replicated ``DTensor`` whose local tensor is the buffer itself.

    Views have their rules one level down, where the views of ``einsum``
    and of the gradients arrive too (:class:`DTensorViewRules`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        # the method arrives as TensorBase's, the function as torch's
        name = getattr(func, "__name__", None)
        if func is torch.Tensor.backward and len(args) == 1 and not any(
                kwargs.values()):
            # a handler runs with its mode off, and ``Tensor.backward``
            # hands a mode the whole call: the engine is run here with the
            # mode on, so the recompute of the checkpointed layers (remat)
            # takes the rules as their forward did
            from torch.autograd.graph import _engine_run_backward
            loss = args[0]
            with self:
                _engine_run_backward(
                    (loss,), (torch.ones_like(
                        loss, memory_format=torch.preserve_format),),
                    False, False, (), allow_unreachable=True,
                    accumulate_grad=True)
            return None
        if name == "gather":
            x, dim, index = args[:3]
            if (isinstance(x, DTensor) and dim % x.ndim == x.ndim - 1
                    and index.shape[-1] == 1):
                cols = torch.arange(x.shape[-1], device=x.device)
                return torch.where(cols == index, x, 0.0).sum(
                    -1, keepdim=True)
        elif name == "searchsorted" and len(args) >= 2 and all(
                isinstance(t, torch.Tensor) for t in args[:2]) and any(
                isinstance(t, DTensor) for t in args[:2]) and \
                args[0].ndim == args[1].ndim > 1:
            seq, values = args[:2]
            if not isinstance(seq, DTensor):
                seq = _placed(seq, values.device_mesh, [
                    Replicate()] * values.device_mesh.ndim)
            return shardwise(torch.searchsorted, seq, (values,),
                             keep_dims=range(seq.ndim - 1), **kwargs)
        elif name == "log_sigmoid" and isinstance(args[0], DTensor):
            return shardwise(func, args[0])
        elif name == "scatter_" and not isinstance(args[0], DTensor):
            dt = [t for t in args[1:] + tuple(kwargs.values())
                  if isinstance(t, DTensor)]
            if dt:
                mesh = dt[0].device_mesh
                _placed(args[0], mesh, [Replicate()] * mesh.ndim).scatter_(
                    *args[1:], **kwargs)
                return args[0]
        out = func(*args, **kwargs)
        if func is F.embedding and isinstance(out, DTensor) and any(
                p.is_partial() for p in out.placements):
            out = out.redistribute(out.device_mesh, [
                Replicate() if p.is_partial() else p for p in out.placements])
        return out


# ---------------------------------------------------------------------------
# what a step does on one device: FLOPs and collectives
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the collectives a step can issue: DTensor's functional ones and the
# process group's all_reduce (the GNN's DDP)
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class StepCounter(TorchDispatchMode):
    """Counts what one device runs: ``flops`` by ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter.flop_registry``) over its local
    ops, and in ``coll`` the result bytes of every collective, functional
    (``_c10d_functional``, DTensor's) or not (``c10d``, a process group's),
    by kind under JAX's keys.

    A ``DTensor`` op is passed on (``NotImplemented``) so that DTensor can
    turn it into local ops and collectives, which come back here: the
    counts are a device's, not the global program's. Eager PyTorch runs
    every layer, so unlike JAX's HLO parse no loop multiplier is needed.
    ``by_op`` holds the bytes and count of each kind by the ``DTensor`` op
    that issued it (``"all-reduce at aten.where.self"``)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry
        self._op = "none"
        self.flops = 0
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}
        self.coll["count"] = 0
        self.by_op = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            self._op = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = self._flops.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _KIND.get(packet.__name__)
            if kind is not None:
                n = _nbytes(out)
                self.coll[kind] += n
                self.coll["count"] += 1
                b, c = self.by_op.get(f"{kind} at {self._op}", (0, 0))
                self.by_op[f"{kind} at {self._op}"] = (b + n, c + 1)
        return out


def collective_bytes(counter: StepCounter) -> dict:
    """JAX's ``collective_bytes`` record from a :class:`StepCounter`: the
    bytes of each kind, ``count`` and ``total``."""
    out = dict(counter.coll)
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out


def top_collectives(counter: StepCounter, n: int = 8) -> list:
    """The ``n`` largest entries of ``counter.by_op``: ``[what, bytes,
    count]``, largest first."""
    top = sorted(counter.by_op.items(), key=lambda kv: -kv[1][0])[:n]
    return [[k, b, c] for k, (b, c) in top]


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for one step of the given shape: ``{name: (shape,
    dtype)}``."""
    b = shape.global_batch
    if shape.kind == "decode":
        # ONE new token against a seq_len-sized cache/state
        return {"tokens": ((b, 1), torch.int32)}
    s_text = shape.seq_len
    out = {}
    if cfg.frontend == "vision":
        s_text = shape.seq_len - cfg.n_frontend_tokens
        out["prefix_embeds"] = ((b, cfg.n_frontend_tokens, cfg.d_model),
                                torch.bfloat16)
    if cfg.frontend == "audio":
        out["audio_embeds"] = ((b, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
    out["tokens"] = ((b, s_text), torch.int32)
    if shape.kind == "train":
        out["labels"] = ((b, s_text), torch.int32)
    return out


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention architecture: long_500k requires "
                "sub-quadratic attention (DESIGN.md S5)")
    return None


# ---------------------------------------------------------------------------
# step builders: the port's own step functions
# ---------------------------------------------------------------------------

def _microbatches(batch: dict, accum: int):
    """``accum`` microbatches of a batch of ``DTensor``s sharded on dim 0:
    microbatch i takes chunk i of every device's rows, so no row moves
    between devices (JAX reshapes to (accum, B / accum, ...))."""
    from torch.distributed.tensor import DTensor
    if accum == 1:
        return [batch]
    out = [dict() for _ in range(accum)]
    for k, v in batch.items():
        size = list(v.shape)
        size[0] //= accum
        if v.to_local().shape[0] % accum:
            raise ValueError(
                f"{k}: a device's {v.to_local().shape[0]} rows do not split "
                f"into {accum} microbatches (grad_accum)")
        for i, c in enumerate(v.to_local().chunk(accum)):
            out[i][k] = DTensor.from_local(
                c, v.device_mesh, v.placements, run_check=False,
                shape=torch.Size(size), stride=_contiguous(size))
    return out


def make_train_step(api, cfg: ModelConfig, between=None):
    """``step(model, opt, batch) -> (opt, loss, grad_norm)``: the
    registry's ``train_loss`` over ``cfg.grad_accum`` microbatches, each
    loss and gradient divided by their count (gradient aggregation on the
    batch axis), then the LLM trainer's ``adam_update`` over
    ``llm_leaves(model)``; parameters are updated in place. ``between()``,
    if given, runs after each microbatch's backward (the dry run clears
    ``MemTracker``'s per-module stats there: it takes a second call of the
    model for a second step)."""
    opt_cfg = AdamConfig(total_steps=2000)
    accum = max(cfg.grad_accum, 1)

    def train_step(model, opt, batch):
        params = [p for _, p in llm_leaves(model)]
        for p in params:
            p.grad = None
        loss = None
        for mb in _microbatches(batch, accum):
            part = api.train_loss(model, mb) / accum
            part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
            if between is not None:
                between()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        new_params, opt, metrics = adam_update(opt_cfg, grads, opt, params)
        with torch.no_grad():
            for p, new in zip(params, new_params):
                p.copy_(new)
        return opt, loss, metrics["grad_norm"]

    return train_step


def make_prefill_step(api):
    def prefill_step(model, batch):
        logits, cache = api.prefill(model, batch)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(api):
    def decode_step(model, cache, batch, pos):
        logits, cache = api.decode(model, cache, batch, pos)
        return logits[:, -1], cache

    return decode_step


# ---------------------------------------------------------------------------
# depth (JAX's probes; the port runs every layer, so these only size)
# ---------------------------------------------------------------------------

def n_groups_of(cfg: ModelConfig) -> int:
    if cfg.is_encoder_decoder:
        return cfg.n_layers                      # enc & dec scale together
    if cfg.ssm is not None and cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    if cfg.ssm is not None:
        return cfg.n_layers // cfg.ssm.slstm_every
    nfd = cfg.moe.first_dense_layers if cfg.moe else 0
    if cfg.layer_pattern == "alt_local_global":
        return (cfg.n_layers - nfd) // 2
    return cfg.n_layers - nfd


def with_groups(cfg: ModelConfig, ng: int) -> ModelConfig:
    if cfg.is_encoder_decoder:
        return cfg.replace(n_layers=ng, encoder_layers=ng)
    if cfg.ssm is not None and cfg.attn_every:
        return cfg.replace(n_layers=ng * cfg.attn_every)
    if cfg.ssm is not None:
        return cfg.replace(n_layers=ng * cfg.ssm.slstm_every)
    nfd = cfg.moe.first_dense_layers if cfg.moe else 0
    if cfg.layer_pattern == "alt_local_global":
        return cfg.replace(n_layers=nfd + 2 * ng)
    return cfg.replace(n_layers=nfd + ng)


# ---------------------------------------------------------------------------
# placing fake tensors
# ---------------------------------------------------------------------------

def _contiguous(size) -> tuple:
    stride, acc = [], 1
    for d in reversed(list(size)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def fake_dtensor(size, dtype, spec, mesh, device):
    """A ``DTensor`` of global ``size`` placed by ``spec``, whose local
    shard (rank 0's) is an empty tensor: fake under ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor, Shard
    pl = shd.placements(spec, mesh)
    local = list(size)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(size), stride=_contiguous(size))


def place_params(model: nn.Module, specs: Optional[Dict[str, shd.Spec]],
                 mesh, device):
    """Replace every parameter of ``model`` (built on ``meta``) by a fake
    ``DTensor`` placed by its spec, or with ``specs`` None by a fake
    tensor (replicated: DDP)."""
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        t = torch.empty(p.shape, dtype=p.dtype, device=device) \
            if specs is None else \
            fake_dtensor(p.shape, p.dtype, specs[name], mesh, device)
        mod._parameters[attr] = nn.Parameter(t, requires_grad=p.requires_grad)


@contextlib.contextmanager
def sharded_caches(cfg: ModelConfig, shape: ShapeConfig, mesh, device):
    """While active, the cache and state factories the models call
    (``transformer.empty_cache``, ``whisper.empty_cache``,
    ``stacks.xlstm_empty_state``, ``stacks.hybrid_empty_state``) return fake
    ``DTensor``s placed by ``sharding.cache_specs``: the cache a prefill
    builds leaves the step sharded, as JAX's ``out_shardings`` place it,
    and the step's in-place writes into it stay ``DTensor`` ops."""
    from repro_torch.models import stacks
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as whi
    targets = [(tfm, "empty_cache"), (whi, "empty_cache"),
               (stacks, "xlstm_empty_state"), (stacks, "hybrid_empty_state")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def placed(fn):
        @functools.wraps(fn)
        def make(*args, **kwargs):
            kwargs["device"] = "meta"
            if fn.__name__ == "xlstm_empty_state" and len(args) > 2:
                args = args[:2]
            meta = fn(*args, **kwargs)
            specs = shd.cache_specs(cfg, shape, mesh, meta)
            return {k: fake_dtensor(t.shape, t.dtype, specs[k], mesh, device)
                    for k, t in meta.items()}
        return make
    try:
        for mod, name, fn in saved:
            setattr(mod, name, placed(fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in torch.utils._pytree.tree_leaves(tensors):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _storages(tensors) -> set:
    from torch.distributed.tensor import DTensor
    out = set()
    for t in torch.utils._pytree.tree_leaves(tensors):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.add(id(t.untyped_storage()))
    return out


def _alias_bytes(outputs, arguments) -> int:
    """Bytes of ``outputs`` whose storage is an argument's (updated in
    place: JAX's donated, aliased buffers)."""
    from torch.distributed.tensor import DTensor
    args = _storages(arguments)
    total = 0
    for t in torch.utils._pytree.tree_leaves(outputs):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor) and \
                id(t.untyped_storage()) in args:
            total += t.numel() * t.element_size()
    return total


def mem_tracker():
    """A ``MemTracker`` that keeps the device-wide peak only. Its per-module
    peaks, which the dry run does not read, cost a pass over every module
    seen so far at each op: a full-depth step became quadratic in depth
    (16 granite groups 27.6 s, 12.9 s without the tracker)."""
    from torch.distributed._tools import mem_tracker as mt

    class DeviceMemTracker(mt.MemTracker):
        def _update_peak_stats(self, peak_state) -> None:
            curr = getattr(self, "_curr_mem_snap", None)
            if curr is None:
                return super()._update_peak_stats(peak_state)
            total = getattr(mt, "_TOTAL_KEY", "Total")
            for dev, snap in curr.items():
                if self._peak_mem.get(dev, 0) < snap[total]:
                    self._peak_mem[dev] = snap[total]
                    self._peak_mem_snap[dev] = dict(snap)

    return DeviceMemTracker()


def _peak_bytes(tracker) -> int:
    snap = tracker.get_tracker_snapshot("peak")
    return int(sum(v.get("Total", 0) for v in snap.values()))


def _mode_of(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """JAX's choice: ``param_sharding`` to train; serving has no optimizer
    state, so ``serve_param_sharding``, or for decode
    ``decode_param_sharding`` where a config sets it."""
    if shape.kind == "train":
        return cfg.param_sharding
    if shape.kind == "decode" and cfg.decode_param_sharding:
        return cfg.decode_param_sharding
    return cfg.serve_param_sharding


def _memory(arguments: int, peak: int, outputs: int, alias: int) -> dict:
    return {"argument_bytes": arguments, "output_bytes": outputs,
            "temp_bytes": max(peak - arguments, 0), "alias_bytes": alias}


# ---------------------------------------------------------------------------
# one (cfg, shape, mesh)
# ---------------------------------------------------------------------------

def lower_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               device: str = "cuda") -> dict:
    """Place and run one step of ``cfg`` at ``shape`` on ``mesh`` under
    ``FakeTensorMode``. Returns ``memory`` (per device, bytes):

    * ``argument_bytes``: the step's inputs, each device's shards of the
      parameters, the Adam state (training), the batch and the cache
      (decode);
    * ``temp_bytes``: ``MemTracker``'s peak of live tensors during the
      step, less the arguments: activations, gradients, the new Adam state
      before it replaces the old, temporaries;
    * ``output_bytes``: what the step returns (training: the parameters,
      updated in place, the new Adam state, the loss and gradient norm;
      prefill: the last logits and the cache; decode: the last logits and
      the cache);
    * ``alias_bytes``: the outputs that are arguments updated in place
      (JAX's donated buffers): the parameters, or the decode cache;

    and the :class:`StepCounter` (``counter``) and wall ``seconds``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    api = registry.get_model(cfg)
    mode = _mode_of(cfg, shape)
    model = registry.meta_model(cfg)
    pspecs = shd.param_specs(model, cfg, mesh, mode=mode)
    bspecs = shd.batch_specs(cfg, shape, mesh, mode=mode)
    counter = StepCounter()
    t0 = time.time()
    with _build.dry_run(), fake_dtensor_fixes(), FakeTensorMode(), \
            implicit_replication(), DTensorRules(), \
            sharded_caches(cfg, shape, mesh, device), mesh_context(mesh):
        place_params(model, pspecs, mesh, device)
        tracker = mem_tracker()
        tracker.track_external(model)
        with tracker:
            batch = {k: fake_dtensor(size, dt, bspecs[k], mesh, device)
                     for k, (size, dt) in input_specs(cfg, shape).items()}
            params = [p for _, p in llm_leaves(model)]
            if shape.kind == "train":
                shapes = {n: tuple(p.shape) for n, p in llm_leaves(model)}
                ospecs = shd.optimizer_state_specs(
                    shapes, {n: pspecs[n] for n in shapes}, mesh)

                def moments():
                    return [fake_dtensor(shapes[n], torch.float32, ospecs[n],
                                         mesh, device) for n in shapes]
                opt = AdamState(step=torch.zeros((), dtype=torch.int32,
                                                 device=device),
                                mu=moments(), nu=moments())
                arguments = (params, opt, batch)
                with counter, DTensorViewRules():
                    opt, loss, gnorm = make_train_step(
                        api, cfg, between=tracker.reset_mod_stats)(
                            model, opt, batch)
                outputs = (params, opt, loss, gnorm)
            elif shape.kind == "prefill":
                arguments = (params, batch)
                with counter, DTensorViewRules():
                    outputs = make_prefill_step(api)(model, batch)
            else:
                cache = api.empty_cache(shape.global_batch, shape.seq_len,
                                        device=device)
                arguments = (params, cache, batch)
                with counter, DTensorViewRules():
                    outputs = make_decode_step(api)(
                        model, cache, batch, shape.seq_len - 1)
            arg_bytes = _local_bytes(arguments)
            out_bytes = _local_bytes(outputs)
            alias = _alias_bytes(outputs, arguments)
        peak = _peak_bytes(tracker)
    return {"memory": _memory(arg_bytes, peak, out_bytes, alias),
            "counter": counter, "seconds": time.time() - t0, "mode": mode}


def _roofline(flops: float, hbytes: float, coll_total: float) -> dict:
    t_compute = flops / HW.peak_flops
    t_memory = hbytes / HW.hbm_bw
    t_coll = coll_total / HW.ici_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             device: str = "cuda", cfg: Optional[ModelConfig] = None,
             mesh=None) -> dict:
    """The record of one (arch, shape) on the production mesh (or
    ``mesh``), in JAX's JSON layout; ``cfg`` overrides the arch's config
    (tests run a reduced one)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type=device)
    mesh_name = "x".join(map(str, shd.mesh_shape(mesh).sizes))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "torch": torch.__version__}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        return rec
    chips = mesh.size()
    run = lower_step(cfg, shape, mesh, device)
    coll = collective_bytes(run["counter"])

    cost = costmodel.step_cost(cfg, shape)
    flops = cost.flops / chips
    hbytes = cost.hbm_bytes / chips

    n_active = registry.active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops_pd = mult * n_active * tokens / chips

    rec.update({
        "chips": chips,
        "param_sharding": run["mode"],
        "compile_seconds": round(run["seconds"], 1),
        "memory": run["memory"],
        "per_device": {
            "flops": flops,
            "hbm_bytes": hbytes,
            "collective_bytes": coll["total"],
            "collective_breakdown": {k: v for k, v in coll.items()
                                     if k != "total"},
            "collective_top": top_collectives(run["counter"]),
            # FlopCounterMode's formulas over the ops a device ran (JAX:
            # cost_analysis as reported)
            "hlo_raw": {"flops": float(run["counter"].flops),
                        "coll": coll},
        },
        "roofline": _roofline(flops, hbytes, coll["total"]),
        "model_flops_per_device": model_flops_pd,
        "useful_flops_ratio": (model_flops_pd / flops) if flops else None,
        "n_active_params": n_active,
        "n_params": registry.param_count(cfg),
    })
    return rec


# ---------------------------------------------------------------------------
# the paper's own model: X-MGN partitions-as-DDP on the production mesh
# ---------------------------------------------------------------------------

def xmgn_local_shapes(cfg: GNNConfig, chips: int) -> dict:
    """JAX's per-device partition of the paper's 2M-node finest level: one
    partition + halo a device, padded to 3x its owned nodes, with k + 2
    edges a node (16 x 16: 7,812 owned, 23,436 nodes, 187,488 edges)."""
    n_nodes_global = max(cfg.levels)
    n_owned = n_nodes_global // chips
    pad_nodes = 3 * n_owned
    pad_edges = pad_nodes * (cfg.k_neighbors + 2)
    return {"n_nodes_global": n_nodes_global, "n_owned": n_owned,
            "pad_nodes": pad_nodes, "pad_edges": pad_edges}


def xmgn_batch_shapes(cfg: GNNConfig, nodes: int, edges: int) -> dict:
    """One device's (1, ...) partition batch: ``{name: (shape, dtype)}``."""
    f32, i32 = torch.float32, torch.int32
    return {"node_feats": ((1, nodes, cfg.node_in), f32),
            "edge_feats": ((1, edges, cfg.edge_in), f32),
            "senders": ((1, edges), i32), "receivers": ((1, edges), i32),
            "targets": ((1, nodes, cfg.node_out), f32),
            "loss_mask": ((1, nodes), f32), "edge_mask": ((1, edges), f32)}


def xmgn_analytic(cfg: GNNConfig, nodes: int, edges: int,
                  n_params: int) -> tuple:
    """JAX's per-device FLOPs (encoder + MP layers + decoder, forward x 4:
    backward and remat) and HBM bytes of one X-MGN step."""
    h, L, ml = cfg.hidden, cfg.n_mp_layers, cfg.mlp_layers
    E, N = edges, nodes
    enc = N * 2 * (cfg.node_in * h + ml * h * h) + \
        E * 2 * (cfg.edge_in * h + ml * h * h)
    per_layer = E * 2 * (3 * h * h + (ml - 1) * h * h) + \
        N * 2 * (2 * h * h + (ml - 1) * h * h) + E * h * 2
    dec = N * 2 * (ml * h * h + h * cfg.node_out)
    flops = 4.0 * (enc + L * per_layer + dec)
    hbytes = 2 * (N + E) * h * 4 * 2 * L + 12 * n_params
    return flops, hbytes


def run_xmgn(multi_pod: bool, device: str = "cuda",
             cfg: Optional[GNNConfig] = None, mesh=None) -> dict:
    """Dry-run the paper's model at paper scale: a 2M-node graph split into
    one partition + halo a device, DDP over ALL mesh axes (the paper's
    scheme has no tensor parallelism): the port's partitions-as-DDP
    gradient (``core.distributed_mgn.make_xmgn_ddp_grad_fn``) with its one
    ``all_reduce`` a step, on a group of every rank of the mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.distributed_mgn import make_xmgn_ddp_grad_fn
    from repro_torch.models.meshgraphnet import MeshGraphNet

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type=device)
    chips = mesh.size()
    cfg = cfg or GNNConfig()                # paper: hidden 512, 15 MP layers
    sh = xmgn_local_shapes(cfg, chips)
    nodes, edges = sh["pad_nodes"], sh["pad_edges"]
    group = dist.new_group(list(range(chips)))
    denom = float(sh["n_nodes_global"] * cfg.node_out)
    counter = StepCounter()
    t0 = time.time()
    with _build.dry_run(), FakeTensorMode():
        with torch.device("meta"):
            model = MeshGraphNet(cfg)
        place_params(model, None, mesh, device)
        tracker = mem_tracker()
        tracker.track_external(model)
        with tracker:
            stacked = {k: torch.empty(size, dtype=dt, device=device)
                       for k, (size, dt) in xmgn_batch_shapes(
                           cfg, nodes, edges).items()}
            arguments = (list(model.parameters()), stacked)
            with counter:
                loss = make_xmgn_ddp_grad_fn(group)(model, stacked, denom)
            grads = [p.grad for p in model.parameters()]
            arg_bytes = _local_bytes(arguments)
            memory = _memory(arg_bytes, _peak_bytes(tracker),
                             _local_bytes((loss, grads)), 0)
    secs = time.time() - t0
    coll = collective_bytes(counter)
    n_params = sum(p.numel() for p in model.parameters())
    flops, hbytes = xmgn_analytic(cfg, nodes, edges, n_params)
    roof = _roofline(flops, hbytes, coll["total"])
    roof["t_compute_f32_s"] = flops / HW.peak_flops_f32
    return {
        "arch": "xmgn-drivaer", "shape": "train_2M_3level",
        "mesh": "x".join(map(str, shd.mesh_shape(mesh).sizes)), "chips": chips,
        "torch": torch.__version__,
        "compile_seconds": round(secs, 1),
        "local": sh,
        "memory": memory,
        "per_device": {"flops": flops, "hbm_bytes": hbytes,
                       "collective_bytes": coll["total"],
                       "collective_breakdown": {
                           k: v for k, v in coll.items() if k != "total"},
                       "hlo_raw": {"flops": float(counter.flops),
                                   "coll": coll}},
        "roofline": roof,
        "useful_flops_ratio": 1.0,
        "n_params": n_params,
        "note": "paper model; ONE gradient all_reduce per step (SIV claim)",
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            device: str = "cuda") -> dict:
    """:func:`run_xmgn` or :func:`run_pair`; a failure is recorded with
    ``error`` (a fault to repair), as JAX's ``main`` records it."""
    t0 = time.time()
    try:
        if arch == "xmgn-drivaer":
            rec = run_xmgn(multi_pod, device)
        else:
            rec = run_pair(arch, shape_name, multi_pod, device)
    except Exception as e:  # record failures; they are bugs to fix
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "torch": torch.__version__,
               "error": f"{type(e).__name__}: {e}"}
    rec["wall_seconds"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch of ASSIGNED_ARCHS x SHAPES, and "
                    "xmgn-drivaer")
    ap.add_argument("--out", default=None,
                    help="default: results/dryrun_torch_{sp,mp}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (fake tensors: nothing "
                    "is allocated on it)")
    args = ap.parse_args(argv)
    out = args.out or DEFAULT_OUT[args.multi_pod]

    init_fake_world(WORLD)
    os.makedirs(out, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
        combos.append(("xmgn-drivaer", "train_2M_3level"))
    else:
        if args.arch is None:
            ap.error("--arch (and --shape) or --all")
        shape = args.shape or ("train_2M_3level"
                               if args.arch == "xmgn-drivaer" else None)
        if shape is None:
            ap.error("--shape is needed for an LLM arch")
        combos = [(args.arch, shape)]

    recs = []
    for arch, shape_name in combos:
        tag = f"{arch}__{shape_name}__{'mp' if args.multi_pod else 'sp'}"
        path = os.path.join(out, tag + ".json")
        if os.path.exists(path):
            print("skip (exists):", tag, flush=True)
            continue
        print("=== dryrun:", tag, flush=True)
        rec = run_one(arch, shape_name, args.multi_pod, args.device)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        recs.append(rec)
        if "error" in rec:
            print("    ERROR:", rec["error"][:500], flush=True)
        elif "skipped" in rec:
            print("    skipped:", rec["skipped"][:120], flush=True)
        else:
            r = rec["roofline"]
            print(f"    ok: dominant={r['dominant']} "
                  f"t_c={r['t_compute_s']:.2e} t_m={r['t_memory_s']:.2e} "
                  f"t_x={r['t_collective_s']:.2e} "
                  f"wall={rec['wall_seconds']}s", flush=True)
            for what, b, c in rec["per_device"].get("collective_top", [])[:3]:
                print(f"      {b / 1e9:.3f} GB in {c}: {what}", flush=True)
    return recs


if __name__ == "__main__":
    main()
