"""The X-MeshGraphNet trainer, and the LLM trainer, on PyTorch.

Port of ``repro.launch.train``. The GNN path: partitioned training with
halo regions and gradient aggregation on synthetic DrivAerML-proxy data
(paper SIII-A). Each step stages one sample's stacked (P, ...) partition
batch on the device and runs forward and backward partition by partition,
each partition's loss divided by the sample's global denominator, so that
autograd's summed gradients are the full-graph gradients. Then the
gradients are clipped to global norm 32 and Adam takes one step with a
cosine learning rate; a step whose loss or any gradient is not finite is
skipped, parameters and Adam state untouched.

In one process this is JAX's ``mesh=None`` path. Under ``torch.distributed``
(one process per rank, e.g. ``torchrun``) it is JAX's sharded path: rank r
runs partitions ``[r P / n, (r + 1) P / n)`` of each sample, and the loss and
gradients of every rank meet in ONE ``all_reduce`` a step
(``core.gradient_aggregation.ddp_aggregate_gradients``); every rank then
takes the same Adam step, so the parameters stay the same on every rank.

On the card the processor's aggregation runs the segment-sum kernel forward
and its hand-written backward kernel; with ``cfg.remat`` each
message-passing layer runs forward twice (once more in the backward pass).

Checkpoints are the JAX trainer's (``repro_torch.ckpt.checkpoint``, the
same msgpack tree), so a run resumes from either package's file; the loop
records ``train_stage_*_seconds`` histograms and spans
(``repro_torch.telemetry``) and has the ``train.batch`` fault site.

The LLM path (``train_llm``, any arch of ``configs.ASSIGNED_ARCHS``) is
JAX's: synthetic token streams (``data.tokens``), the registry's
``train_loss`` (plain attention, remat per layer group), autograd, and the
same Adam over ``models.convert.llm_leaves``, in the config's dtype (bf16
parameters, f32 moments at full size; f32 reduced). It prints JAX's log
lines and ``final loss X (from Y)``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 3 --samples 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --reduced --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 3 --samples 3 --device cpu --ckpt ckpts/x.msgpack \
      --ckpt-every 1 --keep-ckpts 2 --telemetry --trace-dir traces/x
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 5 --samples 3 --device cpu --resume ckpts/x.msgpack
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 2 --samples 3 --device cpu --graph-source graphx
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 100 --samples 8
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch xmgn-drivaer --reduced --steps 3 \
      --samples 3 --device cpu --dist-backend gloo
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import compile_cache
from repro_torch.configs import get_config
from repro_torch.configs.base import GNNConfig, ModelConfig
from repro_torch.core.gradient_aggregation import (aggregate_gradients,
                                                   ddp_aggregate_gradients)
from repro_torch.data import pipeline as pipe
from repro_torch.data.tokens import token_batches
from repro_torch.device import resolve
from repro_torch.launch.sharding import (init_process_group, rank_device,
                                         shard_count_for, shard_put,
                                         shard_range)
from repro_torch.models import meshgraphnet, registry
from repro_torch.models.convert import (adam_state_from_jax,
                                        adam_state_to_jax, llm_leaves,
                                        params_from_jax, params_to_jax)
from repro_torch.models.meshgraphnet import MeshGraphNet, loss_fn
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.resilience import faults
from repro_torch.telemetry import (Telemetry, clock_ns,
                                   default_latency_buckets, span)

# training-loop stages whose wall time lands in the metrics registry as
# ``train_stage_<name>_seconds`` histograms, as in the JAX trainer
TRAIN_STAGES = ("data", "partition", "prepare", "step", "eval", "checkpoint")


def _stage_hists(tel: Telemetry) -> dict:
    return {s: tel.metrics.histogram(
        f"train_stage_{s}_seconds",
        help=f"wall seconds spent in the '{s}' training stage",
        buckets=default_latency_buckets())
        for s in TRAIN_STAGES}


def make_gnn_step_fn(cfg: GNNConfig, opt_cfg: AdamConfig, group=None):
    """One optimizer step over a stacked (P, ...) partition batch.

    Returns ``step(model, opt, stacked, denom) -> (opt, loss, grad_norm,
    skipped)``: the model's parameters are updated in place and the new Adam
    state returned. ``stacked`` and ``denom`` come from
    :func:`prepare_gnn_batch`, on the model's device.

    ``group=None`` runs every partition of ``stacked`` in this process.
    With a ``torch.distributed`` group, ``stacked`` is this rank's slice and
    the per-rank sums meet in one ``all_reduce``
    (:func:`ddp_aggregate_gradients`); every rank of the group must take
    every step. The loss, the gradients, the guard's verdict and the Adam
    step are then the same on every rank.

    Nonfinite guard (``cfg.nonfinite_guard``, default on): when the loss
    or any gradient is NaN/Inf the update is SKIPPED: the parameters and
    the Adam state stay as they were, bit for bit, and ``skipped`` is True.
    Sharded, the verdict is read from the summed loss and gradients, so a
    nonfinite value on one rank makes every rank skip.

    Under a running ``torch.profiler`` a step is spans
    (``telemetry.span``): ``forward_backward`` per partition, ``adam``
    (the update's launches) and ``guard`` (the verdict's host read, which
    waits for the step on the device).
    """
    guard = bool(cfg.nonfinite_guard)

    def step_fn(model: MeshGraphNet, opt, stacked: dict, denom):
        n_parts = stacked["senders"].shape[0]
        batches = ({k: v[p] for k, v in stacked.items()}
                   for p in range(n_parts))
        if group is None:
            loss = aggregate_gradients(lambda m, b: loss_fn(m, b, denom),
                                       model, batches)
        else:
            loss = ddp_aggregate_gradients(
                lambda m, b: loss_fn(m, b, denom), model, batches, group)
        params = [p for _, p in model.leaves()]
        grads = [p.grad for p in params]
        with span("adam"):
            new_params, new_opt, metrics = adam_update(opt_cfg, grads, opt,
                                                       params)
        skipped = False
        if guard:
            with span("guard"):
                finite = torch.isfinite(loss) & torch.stack(
                    [torch.isfinite(g).all() for g in grads]).all()
                skipped = not bool(finite)
        if not skipped:
            with torch.no_grad():
                for p, new in zip(params, new_params):
                    p.copy_(new)
            opt = new_opt
        return opt, loss, metrics["grad_norm"], skipped
    return step_fn


def prepare_gnn_batch(ps: pipe.PartitionedSample, device, rank: int = 0,
                      n_shards: int = 1):
    """One partitioned sample on ``device``: ``(stacked, denom)``, the
    stacked arrays of rank ``rank``'s partitions when ``n_shards`` ranks
    split them (``launch.sharding.shard_put``; all P of them by default) as
    tensors, and the whole sample's loss denominator as an f32 scalar."""
    dev = torch.device(device)
    stacked = shard_put(ps.stacked, rank, n_shards, dev)
    return stacked, torch.tensor(ps.denom, dtype=torch.float32, device=dev)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_gnn(cfg: GNNConfig, steps: int, n_samples: int,
              ckpt_path: Optional[str] = None, log_every: int = 10,
              telemetry: Optional[Telemetry] = None, ckpt_every: int = 0,
              resume: Optional[str] = None,
              opt_total_steps: Optional[int] = None,
              keep_ckpts: Optional[int] = None,
              noise_std: Optional[float] = None,
              graph_source: Optional[str] = None,
              shard_devices: Optional[int] = None, device=None):
    """Train X-MeshGraphNet on partitioned synthetic DrivAerML-proxy data,
    on ``device`` (default: the card).

    Sharded when ``torch.distributed`` is initialised: every rank builds the
    same dataset and weights from the seeds, takes the partitions
    ``[r P / n, (r + 1) P / n)`` of each sample, where ``n`` is the largest
    rank count that divides P (at most ``shard_devices``; ranks past ``n``
    hold none and add zeros), and the ranks' sums meet in one
    ``all_reduce`` a step (:func:`make_gnn_step_fn` with the default
    group). Only rank 0 writes checkpoints; a resume restores the same file
    on every rank. Telemetry and the fault sites work per rank; the
    ``train.batch`` site corrupts the rank's own partitions.

    ``graph_source`` (default ``cfg.graph_source``) selects the training
    graph build: ``"host"`` (cKDTree) or ``"graphx"`` (the hash-grid union,
    its kNN kernel on ``device``); both give the same edge set.

    Checkpointing, as the JAX trainer: ``ckpt_path`` is written after the
    final step and, with ``ckpt_every > 0``, every that-many steps on a
    background thread (:class:`repro_torch.ckpt.checkpoint.
    AsyncCheckpointer`; write seconds land in the ``checkpoint`` stage
    histogram). With ``keep_ckpts > 0`` (default ``cfg.keep_ckpts``) the
    periodic saves go to step-tagged siblings ``<path>.stepNNNNNNNN``,
    pruned to the newest ``keep_ckpts``. A checkpoint is the JAX trainer's
    tree (params in the JAX layout, the Adam state ``{step, mu, nu}``, the
    loop step, the schedule horizon, the normalizers), so either package
    resumes the other's. ``resume=<path>`` restores it (falling back past a
    corrupt newest file to the previous retained one) and continues the
    optimizer trajectory exactly: training N steps equals training k and
    resuming to N. ``opt_total_steps`` is the cosine-schedule horizon
    (default: the checkpoint's on resume, else ``steps``).

    ``noise_std`` (default ``cfg.noise_std``; 0 = off) adds MGN-style
    training noise to the node features each step, drawn on the host from
    ``np.random.default_rng((0xF10A7, it))`` for global step ``it``, as the
    JAX trainer draws it. Weights come from ``torch.Generator`` seed 0.

    ``telemetry`` (default: from the config's ``telemetry``/``trace_dir``
    fields) records the loop's stages as ``train_stage_<name>_seconds``
    histograms, always, and as spans (``data``, ``partition``, ``step``
    with ``trace_id="step-<it>"``, nested ``prepare``, ``checkpoint``) when
    its tracer is on, and under a running ``torch.profiler`` whatever it
    says. A step's time runs to the end of its update on the device;
    ``prepare`` is its batch staged on the device.

    Returns ``(model, losses, (train, test, norm_in, norm_out))``.
    """
    dev = resolve(device)
    if graph_source is not None:
        cfg = cfg.replace(graph_source=graph_source)
    group, rank, world = None, 0, 1
    if dist.is_available() and dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    # the kernels' build directory: a restarted trainer loads the libraries
    # an earlier process built there instead of running nvcc
    compile_cache.enable(cfg.compile_cache_dir)
    tel = telemetry if telemetry is not None else Telemetry.from_config(cfg)
    hists = _stage_hists(tel)
    loss_gauge = tel.metrics.gauge("train_loss",
                                   help="most recent training loss")
    steps_ctr = tel.metrics.counter("train_steps_total",
                                    help="optimizer steps taken")
    with tel.span("data", n_samples=n_samples):
        t0 = time.perf_counter()
        train, test, norm_in, norm_out = pipe.build_dataset(cfg, n_samples,
                                                            device=dev)
        hists["data"].observe(time.perf_counter() - t0)
    # one partitioning pass per sample + common padding: one shape for all
    with tel.span("partition", n_samples=len(train)):
        t0 = time.perf_counter()
        psamples = pipe.partition_samples(cfg, train, norm_in, norm_out)
        hists["partition"].observe(time.perf_counter() - t0)

    model = meshgraphnet.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    start_step = 0
    restored = None
    if resume:
        # a corrupt newest checkpoint falls back to the previous intact one
        # of the --keep-ckpts window
        restored, used_path, skipped_paths = ckpt.restore_with_fallback(
            resume)
        for p in skipped_paths:
            print(f"WARNING: skipped corrupt checkpoint {p}", flush=True)
        if used_path != resume:
            print(f"resuming from retained fallback {used_path}", flush=True)
        if "params" not in restored:
            raise ckpt.CheckpointError(
                f"{used_path!r} is not a training checkpoint (no 'params')")
        model = params_from_jax(restored["params"], cfg, device=dev)
    if opt_total_steps is None:
        # a resumed run keeps the original cosine horizon
        opt_total_steps = int(restored["opt_total_steps"]) \
            if restored and "opt_total_steps" in restored else steps
    opt_cfg = AdamConfig(total_steps=int(opt_total_steps))
    opt = adam_init([p for _, p in model.leaves()])
    if restored is not None and "opt" in restored:
        opt = adam_state_from_jax(restored["opt"], model)
        start_step = int(restored.get("step", 0))
        print(f"resumed {resume} at step {start_step} "
              f"(schedule horizon {opt_cfg.total_steps})", flush=True)

    def ckpt_tree(next_step):
        return {"params": params_to_jax(model),
                "opt": adam_state_to_jax(opt, model),
                "step": int(next_step),
                "opt_total_steps": int(opt_cfg.total_steps),
                "norm_in": vars(norm_in), "norm_out": vars(norm_out)}

    n_parts = cfg.n_partitions
    n_shards = shard_count_for(n_parts, world, limit=shard_devices)
    part = shard_range(n_parts, rank, n_shards)
    if group is not None and rank == 0:
        print(f"partition-parallel: {n_parts} partitions over {n_shards} of "
              f"{world} ranks ({n_parts // n_shards} per rank, one "
              "all_reduce per step)", flush=True)
    step_fn = make_gnn_step_fn(cfg, opt_cfg, group=group)
    writes = rank == 0                   # one checkpoint writer
    if keep_ckpts is None:
        keep_ckpts = int(cfg.keep_ckpts)
    if noise_std is None:
        noise_std = float(cfg.noise_std)
    skip_ctr = tel.metrics.counter(
        "train_nonfinite_steps_total",
        help="optimizer steps skipped on a nonfinite loss/grad")
    nonfinite_steps = 0
    losses = []
    step_s = []
    writer = ckpt.AsyncCheckpointer(on_write=hists["checkpoint"].observe)
    for it in range(start_step, steps):
        # stage one sample per step: at paper scale a padded partition
        # batch is GBs, so only the current one lives on the device.
        # Indexing by the GLOBAL step keeps the sample sequence identical
        # across a crash+resume.
        _sync(dev)
        with tel.span("step", trace_id=f"step-{it}", it=it):
            tp0 = time.perf_counter()
            with tel.span("prepare"):
                ps = psamples[it % len(psamples)]
                stacked, denom = prepare_gnn_batch(ps, dev, rank, n_shards)
                nf_all = ps.stacked["node_feats"]
                nf = nf0 = nf_all[part.start:part.stop]
                if faults.active():
                    # chaos: poison this step's node features so the
                    # nonfinite skip-step guard has something to catch
                    nf = faults.corrupt("train.batch", nf)
                if noise_std > 0.0:
                    # MGN rollout-stability noise, seeded by the global
                    # step, drawn for the whole sample on every rank
                    nrng = np.random.default_rng((0xF10A7, it))
                    nf = nf + nrng.standard_normal(nf_all.shape).astype(
                        nf.dtype)[part.start:part.stop] * noise_std
                if nf is not nf0:
                    stacked["node_feats"] = torch.from_numpy(
                        np.ascontiguousarray(nf)).to(dev)
                _sync(dev)
            tp1 = time.perf_counter()
            tp1_ns = clock_ns()
            first = it == start_step
            with span(f"train/step{'_first' if first else ''}"):
                opt, loss, gnorm, skipped = step_fn(model, opt, stacked,
                                                    denom)
                losses.append(float(loss))
                _sync(dev)              # the update, to its end
            if skipped:
                nonfinite_steps += 1
                skip_ctr.inc()
                tel.tracer.record_span("nonfinite_skip", tp1_ns, clock_ns(),
                                       it=it)
                print(f"step {it:5d} SKIPPED: nonfinite loss/grads (loss "
                      f"{losses[-1]}, {nonfinite_steps} skipped so far) - "
                      "params and Adam state unchanged", flush=True)
        hists["prepare"].observe(tp1 - tp0)
        step_s.append(time.perf_counter() - tp1)
        hists["step"].observe(step_s[-1])
        loss_gauge.set(losses[-1])
        steps_ctr.inc()
        if (writes and ckpt_path and ckpt_every > 0
                and (it + 1) % ckpt_every == 0 and it + 1 < steps):
            # async: copied to the host here, written on the ckpt-writer
            # thread; the loop only ever waits for the PREVIOUS write
            with tel.span("checkpoint", path=ckpt_path, it=it):
                if keep_ckpts > 0:
                    writer.save(ckpt.retained_path(ckpt_path, it + 1),
                                ckpt_tree(it + 1))
                    # the in-flight write is not on disk yet; prunable
                    # files are all from completed earlier saves
                    ckpt.prune_retained(ckpt_path, keep_ckpts)
                else:
                    writer.save(ckpt_path, ckpt_tree(it + 1))
        if rank == 0 and it % log_every == 0:
            # warm s/step excludes the first step (allocator and library
            # warm-up)
            warm = step_s[1:]
            timing = (f"first {step_s[0]:.2f}s" if not warm else
                      f"{sum(warm) / len(warm):.2f}s/step warm, first "
                      f"{step_s[0]:.2f}s")
            print(f"step {it:5d} loss {losses[-1]:.5f} gnorm "
                  f"{float(gnorm):.3f} ({timing})", flush=True)
    writer.wait()                          # surface any background failure
    if writes and ckpt_path:
        with tel.span("checkpoint", path=ckpt_path):
            t0 = time.perf_counter()
            ckpt.save(ckpt_path, ckpt_tree(steps))
            hists["checkpoint"].observe(time.perf_counter() - t0)
    return model, losses, (train, test, norm_in, norm_out)


def predict_gnn(cfg: GNNConfig, model: MeshGraphNet, samples, norm_in,
                norm_out):
    """Denormalized full-cloud predictions on the model's device.

    Samples are partitioned with common padding (``partition_samples``);
    each partition runs forward on its own, and owned-node predictions are
    reassembled in global order and decoded with ``norm_out``.
    """
    psamples = pipe.partition_samples(cfg, samples, norm_in, norm_out)
    dev = next(model.parameters()).device
    keys = ("node_feats", "edge_feats", "senders", "receivers", "edge_mask")
    preds = []
    with torch.no_grad():
        for s, ps in zip(samples, psamples):
            b = {k: torch.from_numpy(ps.stacked[k]).to(dev) for k in keys}
            preds_p = np.stack([
                model.apply(b["node_feats"][p], b["edge_feats"][p],
                            b["senders"][p], b["receivers"][p],
                            edge_mask=b["edge_mask"][p]).cpu().numpy()
                for p in range(b["senders"].shape[0])])
            pred = np.zeros((s.graph.n_nodes, cfg.node_out), np.float32)
            nodes = np.asarray(ps.padded["nodes_global"])
            owned = np.asarray(ps.padded["owned_mask"]) > 0
            pred[nodes[owned]] = preds_p[owned]
            preds.append(norm_out.decode(pred))
    return preds


def eval_gnn(cfg: GNNConfig, model: MeshGraphNet, samples, norm_in,
             norm_out) -> dict:
    """Paper Table I metrics on denormalized predictions."""
    errs = {"pressure": [[], []], "tau_x": [[], []], "tau_y": [[], []],
            "tau_z": [[], []]}
    names = list(errs)
    forces_true, forces_pred = [], []
    preds = predict_gnn(cfg, model, samples, norm_in, norm_out)
    for s, pred in zip(samples, preds):
        true = s.targets
        for i, nm in enumerate(names):
            num = np.linalg.norm(pred[:, i] - true[:, i])
            den = np.linalg.norm(true[:, i]) + 1e-12
            errs[nm][0].append(num / den)
            errs[nm][1].append(np.abs(pred[:, i] - true[:, i]).sum()
                               / (np.abs(true[:, i]).sum() + 1e-12))
        n = s.graph.normals
        f_true = ((-true[:, :1] * n + true[:, 1:]).mean(0) @ [1, 0, 0])
        f_pred = ((-pred[:, :1] * n + pred[:, 1:]).mean(0) @ [1, 0, 0])
        forces_true.append(f_true)
        forces_pred.append(f_pred)
    out = {nm: {"rel_l2": float(np.mean(v[0])),
                "rel_l1": float(np.mean(v[1]))}
           for nm, v in errs.items()}
    ft, fp = np.asarray(forces_true), np.asarray(forces_pred)
    ss_res = np.sum((ft - fp) ** 2)
    ss_tot = np.sum((ft - ft.mean()) ** 2) + 1e-12
    out["force_r2"] = float(1.0 - ss_res / ss_tot)
    return out


def make_llm_step_fn(cfg: ModelConfig, opt_cfg: AdamConfig):
    """One optimizer step of an LLM (JAX's jitted ``step_fn`` of
    ``train_llm``). Returns ``step(model, opt, batch) -> (opt, loss,
    grad_norm)``: the registry's ``train_loss`` on ``batch`` (tensors on
    the model's device), its backward, then ``adam_update`` over
    ``llm_leaves(model)`` (marked ``llm.adam_update`` for
    ``torch.profiler``); the parameters are updated in place and their
    ``.grad`` keep this step's gradients."""
    api = registry.get_model(cfg)

    def step_fn(model, opt, batch):
        params = [p for _, p in llm_leaves(model)]
        for p in params:
            p.grad = None
        loss = api.train_loss(model, batch)
        loss.backward()
        # a parameter the loss does not reach has JAX's zero gradient
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        with span("llm.adam_update"):
            new_params, opt, metrics = adam_update(opt_cfg, grads, opt,
                                                   params)
            with torch.no_grad():
                for p, new in zip(params, new_params):
                    p.copy_(new)
        return opt, loss.detach(), metrics["grad_norm"]
    return step_fn


def stub_frontend(cfg: ModelConfig, batch: int, device) -> dict:
    """The stubbed frontend's input of a training batch, as JAX's
    ``train_llm`` gives it: zero patch embeddings (``prefix_embeds``) for a
    vision frontend, zero frame embeddings (``audio_embeds``) for an audio
    one, each (batch, n_frontend_tokens, d) f32; none for the rest."""
    key = {"vision": "prefix_embeds", "audio": "audio_embeds"}.get(
        cfg.frontend)
    if key is None:
        return {}
    return {key: torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                             device=device)}


def train_llm(arch: str, reduced: bool, steps: int, batch: int = 4,
              seq: int = 64, log_every: int = 5, *, device=None, model=None):
    """JAX's ``train_llm``: ``steps`` Adam steps (lr 3e-4, cosine over
    ``steps``) of ``arch`` (``reduced``: its ``cfg.reduced()``) on
    ``token_batches(vocab, batch, seq, steps)``, with zero patch or frame
    embeddings for a vision or audio frontend, printing the loss every
    ``log_every`` steps. ``device``: the card by default, or "cpu".
    ``model``: start from these weights (moved to ``device``) instead of
    ``init(seed=0)``. Returns (model, per-step losses)."""
    cfg = get_config(arch)
    if not isinstance(cfg, ModelConfig):
        raise ValueError(f"train_llm trains an LLM config; {arch!r} is not")
    if reduced:
        cfg = cfg.reduced()
    dev = resolve(device)
    model = registry.get_model(cfg).init(seed=0, device=dev) \
        if model is None else model.to(dev)
    opt_cfg = AdamConfig(lr_max=3e-4, total_steps=steps)
    opt = adam_init([p for _, p in llm_leaves(model)])
    step_fn = make_llm_step_fn(cfg, opt_cfg)
    extra = stub_frontend(cfg, batch, dev)
    losses = []
    for it, b in enumerate(token_batches(cfg.vocab_size, batch, seq, steps)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        b.update(extra)
        opt, loss, _ = step_fn(model, opt, b)
        losses.append(float(loss))
        if it % log_every == 0:
            print(f"step {it:4d} loss {float(loss):.4f}", flush=True)
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="xmgn-drivaer, or an LLM of ASSIGNED_ARCHS (which "
                    "reads only --reduced, --steps and --device)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--samples", type=int, default=6)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also write --ckpt every N steps (async, on a "
                    "background thread), not just after the final step")
    ap.add_argument("--keep-ckpts", type=int, default=None,
                    help="retain the K newest periodic checkpoints as "
                    "step-tagged siblings of --ckpt; --resume falls back "
                    "past a corrupt newest file to the previous intact one")
    ap.add_argument("--resume", default=None,
                    help="continue training from this checkpoint (either "
                    "package's): params, Adam state, step and LR-schedule "
                    "horizon are restored")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="cosine-schedule horizon when it differs from "
                    "--steps (a resumed run keeps the checkpoint's horizon "
                    "by default)")
    ap.add_argument("--noise-std", type=float, default=None,
                    help="MGN-style training noise: gaussian std added to "
                    "node features each step for rollout stability "
                    "(default: cfg.noise_std, i.e. off)")
    ap.add_argument("--compile-cache", default=None,
                    help="the CUDA kernels' build directory: a restarted "
                    "trainer loads the kernels built there instead of "
                    "running nvcc")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the span tracer + profiler annotations")
    ap.add_argument("--trace-dir", default=None,
                    help="export trace.jsonl / trace_chrome.json / "
                    "metrics.prom / metrics.json here on exit "
                    "(implies --telemetry)")
    ap.add_argument("--profile", action="store_true",
                    help="additionally capture a torch.profiler trace "
                    "under <trace-dir>/torch_profile")
    ap.add_argument("--graph-source", choices=("host", "graphx"),
                    default=None,
                    help="training-graph build: host cKDTree or the graphx "
                    "hash-grid union on the device (mesh-free)")
    ap.add_argument("--shard-devices", type=int, default=None,
                    help="under torchrun: cap the ranks that hold "
                    "partitions (the largest count that divides the "
                    "partitions; 1 = all on rank 0)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="under torchrun: the process group's backend "
                    "(default nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; under torchrun the local rank's "
                    "card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if isinstance(cfg, ModelConfig):
        _, losses = train_llm(args.arch, args.reduced, args.steps,
                              device=args.device)
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
        return
    if not isinstance(cfg, GNNConfig):
        raise SystemExit(f"launch.train trains the GNN and the LLMs; "
                         f"{args.arch!r} is neither (X-UNet3D trains "
                         "through repro_torch.launch.xunet_volume)")
    if args.reduced:
        cfg = cfg.reduced()
    if args.compile_cache:
        cfg = cfg.replace(compile_cache_dir=args.compile_cache)
    device, rank, world = args.device, 0, 1
    if "WORLD_SIZE" in os.environ:
        # under torchrun: one process per rank, the group from its env
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device is None:
            device = rank_device(int(os.environ.get("LOCAL_RANK", rank)))
        device = resolve(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_process_group(rank, world, "env://", backend=args.dist_backend,
                           device=device)
    trace_dir = args.trace_dir
    if trace_dir and world > 1:
        trace_dir = os.path.join(trace_dir, f"rank{rank}")
    if args.telemetry or trace_dir:
        cfg = cfg.replace(telemetry=True, trace_dir=trace_dir or "",
                          profile_capture=args.profile)
    tel = Telemetry.from_config(cfg)
    try:
        with tel.capture():
            model, losses, (train, test, ni, no) = train_gnn(
                cfg, args.steps, args.samples, args.ckpt, telemetry=tel,
                ckpt_every=args.ckpt_every, resume=args.resume,
                opt_total_steps=args.total_steps,
                keep_ckpts=args.keep_ckpts, noise_std=args.noise_std,
                graph_source=args.graph_source,
                shard_devices=args.shard_devices, device=device)
            if rank == 0:
                with tel.span("eval", n_samples=len(test)):
                    t0 = time.perf_counter()
                    metrics = eval_gnn(cfg, model, test, ni, no)
                    tel.metrics.histogram(
                        "train_stage_eval_seconds",
                        help="wall seconds spent in the 'eval' training "
                        "stage").observe(time.perf_counter() - t0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(metrics, indent=2))
    if trace_dir:
        paths = tel.export()
        print("telemetry artifacts: " + ", ".join(sorted(paths.values())))


if __name__ == "__main__":
    main()
