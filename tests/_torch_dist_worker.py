"""Rank processes for ``tests/test_torch_distributed.py``.

Imported by the ranks that the test spawns (the ``spawn`` start method, one
torch thread each, a ``gloo`` group through a ``FileStore`` under the
test's temporary directory). It imports no JAX: the ranks run the port
only, and pass their results back as ``.npz`` files.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import GNNConfig
from repro_torch.core import distributed_mgn as dmgn
from repro_torch.core import gradient_aggregation as ga
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as ptrain
from repro_torch.launch.sharding import shard_count_for, shard_put
from repro_torch.models.meshgraphnet import MeshGraphNet
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.resilience import faults

# a collective or rendezvous that waits longer fails the rank
GROUP_TIMEOUT = timedelta(seconds=60)
# tests/_dist_check.py's graph and model
DIST_CFG = GNNConfig(node_in=6, edge_in=4, node_out=3, hidden=32,
                     n_mp_layers=3, halo=3)
# tests/_train_equiv_check.py's config
TRAIN_CFG = GNNConfig().reduced().replace(levels=(64, 128, 256), hidden=32,
                                          n_mp_layers=2, halo=2,
                                          n_partitions=4)
TRAJ_STEPS = 4
# gradients below this mark the parameters whose Adam update may differ by
# up to 2 lr a step (tests/test_torch_train.py)
NEAR_ZERO = 1e-7


def spawn(world: int, target, out_dir: Path, timeout: float = 120.0,
          backend: str = "gloo"):
    """Run ``target(rank, world, out_dir)`` in ``world`` spawned processes,
    each in a ``backend`` group, and wait at most ``timeout`` seconds for
    all of them; a rank that fails or outlives the limit fails the call,
    and none is left running."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, out_dir, backend),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    errors = [(out_dir / f"error_rank{r}.txt") for r in range(world)]
    detail = "\n".join(e.read_text() for e in errors if e.exists())
    if alive or any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited {codes} ({len(alive)} killed at "
                           f"the {timeout} s limit)\n{detail}")


def _rank_main(target, rank, world, out_dir, backend):
    import traceback
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{out_dir}/store_{target.__name__}",
            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
        try:
            target(rank, world, Path(out_dir))
        finally:
            dist.destroy_process_group()
    except BaseException:
        (Path(out_dir) / f"error_rank{rank}.txt").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _model(state_path: Path, cfg: GNNConfig) -> MeshGraphNet:
    model = MeshGraphNet(cfg)
    model.load_state_dict(torch.load(state_path))
    return model


def _grads(model: MeshGraphNet) -> dict:
    return {n: p.grad.detach().numpy().copy() for n, p in model.leaves()}


def _params(model: MeshGraphNet) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.leaves()}


def grads_job(rank: int, world: int, d: Path):
    """On the graph of tests/_dist_check.py: the DDP gradients over 4
    partitions at W = 1, 2 and 4 (subgroups of the 4 ranks), and at W = 4
    with 2 ranks holding them, and the baseline's at W = 2 and 4, with the
    collectives each made."""
    data = dict(np.load(d / "grads_in.npz"))
    denom = float(data["denom"])
    stacked_np = {k[len("stacked_"):]: v for k, v in data.items()
                  if k.startswith("stacked_")}
    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]),
              4: dist.group.WORLD}
    out = {}
    for w, group in groups.items():
        if rank >= w:
            continue
        model = _model(d / "params.pt", DIST_CFG)
        stacked = shard_put(stacked_np, rank, w, "cpu")
        before = ga.all_reduce.collectives
        loss = dmgn.make_xmgn_ddp_grad_fn(group)(model, stacked, denom)
        out[f"ddp{w}_collectives"] = ga.all_reduce.collectives - before
        out[f"ddp{w}_loss"] = float(loss)
        out.update({f"ddp{w}_{n}": g for n, g in _grads(model).items()})
        if w == 4:
            # 2 of the 4 ranks hold the partitions; the others add zeros
            model = _model(d / "params.pt", DIST_CFG)
            stacked = shard_put(stacked_np, rank, 2, "cpu")
            loss = dmgn.make_xmgn_ddp_grad_fn(group)(model, stacked, denom)
            out["idle_loss"] = float(loss)
            out.update({f"idle_{n}": g for n, g in _grads(model).items()})
        if w == 1:
            continue
        shards_np = {k[len(f"dmgn{w}_"):]: v for k, v in data.items()
                     if k.startswith(f"dmgn{w}_")}
        shard = dmgn.device_put_shards(shards_np, rank, "cpu")
        model = _model(d / "params.pt", DIST_CFG)
        before = ga.all_reduce.collectives
        loss = dmgn.make_dmgn_grad_fn(group, denom)(model, shard)
        out[f"dmgn{w}_collectives"] = ga.all_reduce.collectives - before
        out[f"dmgn{w}_loss"] = float(loss)
        out.update({f"dmgn{w}_{n}": g for n, g in _grads(model).items()})
    np.savez(d / f"grads_rank{rank}.npz", **out)


def train_job(rank: int, world: int, d: Path):
    """Two ranks, every run from the JAX init: the 4-step trajectory of
    ``make_gnn_step_fn(group=...)`` (with the elements whose gradient fell
    below NEAR_ZERO in any step), ``train_gnn`` for 4 steps with
    checkpoints (counting the files each rank writes), and a
    ``train.batch`` corruption on rank 1 alone in the second of 2 steps
    beside a 1-step run, both checkpointed."""
    cfg = TRAIN_CFG
    out, meta = {}, {}
    # train_gnn draws its weights from a torch.Generator: start it from the
    # JAX init instead, as the trajectory does
    ptrain.meshgraphnet.init = \
        lambda gen, c, device=None: _model(d / "params_traj.pt", c)
    train, _, ni, no = pipe.build_dataset(cfg, 3)
    psamples = pipe.partition_samples(cfg, train, ni, no)
    n_shards = shard_count_for(cfg.n_partitions, world)

    # the trajectory: make_gnn_step_fn with the default group ----------------
    model = _model(d / "params_traj.pt", cfg)
    opt_cfg = AdamConfig(total_steps=TRAJ_STEPS)
    step = ptrain.make_gnn_step_fn(cfg, opt_cfg, group=dist.group.WORLD)
    opt = adam_init([p for _, p in model.leaves()])
    before = ga.all_reduce.collectives
    losses, gnorms, near = [], [], {}
    for it in range(TRAJ_STEPS):
        batch = ptrain.prepare_gnn_batch(psamples[it % len(psamples)], "cpu",
                                         rank, n_shards)
        opt, loss, gnorm, skipped = step(model, opt, *batch)
        assert not skipped
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        for n, g in _grads(model).items():
            near[n] = near.get(n, False) | (np.abs(g) < NEAR_ZERO)
    meta["traj_collectives"] = ga.all_reduce.collectives - before
    meta["traj_losses"], meta["traj_gnorms"] = losses, gnorms
    out.update({f"traj_{n}": v for n, v in _params(model).items()})
    out.update({f"near_{n}": v for n, v in near.items()})

    # train_gnn on two ranks, only rank 0 writing its checkpoints ------------
    from repro_torch.ckpt import checkpoint as ckpt
    writes = []
    real_save = ckpt.save

    def counted_save(path, tree):
        writes.append(os.path.basename(path))
        return real_save(path, tree)

    ckpt.save = counted_save
    try:
        model, losses, _ = ptrain.train_gnn(
            cfg, TRAJ_STEPS, 3, str(d / "run.msgpack"), log_every=100,
            ckpt_every=2, keep_ckpts=2, device="cpu")
        meta["run_losses"] = losses
        out.update({f"run_{n}": v for n, v in _params(model).items()})

        # a nonfinite batch on rank 1 only, in step 1 of 2 ----------------
        if rank == 1:
            faults.arm("train.batch", mode="corrupt", nth=2, fill=np.nan)
        try:
            _, losses, _ = ptrain.train_gnn(
                cfg, 2, 3, str(d / "skip.msgpack"), log_every=100,
                opt_total_steps=TRAJ_STEPS, device="cpu")
        finally:
            faults.reset()
        meta["skip_losses"] = losses
        _, losses, _ = ptrain.train_gnn(
            cfg, 1, 3, str(d / "one.msgpack"), log_every=100,
            opt_total_steps=TRAJ_STEPS, device="cpu")
        meta["one_losses"] = losses
    finally:
        ckpt.save = real_save
    meta["writes"] = writes
    np.savez(d / f"train_rank{rank}.npz", **out)
    (d / f"train_rank{rank}.json").write_text(json.dumps(meta))
