"""The port's multi-process training on the CPU (``gloo``) against the JAX
package's device-mesh training.

Both of the paper's schemes: X-MGN partitions-as-DDP
(``core.distributed_mgn.make_xmgn_ddp_grad_fn``, one ``all_reduce`` a step)
and the distributed-MGN baseline (``make_dmgn_grad_fn``, a boundary
exchange in every layer, 2L + 1 collectives a step), and the sharded
trainer (``launch.train.make_gnn_step_fn(group=...)``, ``train_gnn`` under
``torch.distributed``).

* The gradients: on ``tests/_dist_check.py``'s graph (240 points, k = 4, 3
  layers, hidden 32), against JAX's same scheme on as many forced host
  devices and JAX's full-graph ``value_and_grad``.
* The trainer: on ``tests/_train_equiv_check.py``'s config, 4 steps on 2
  ranks against JAX's ``make_gnn_step_fn(mesh=mesh_for_shards(2))`` and the
  port's single-process run; a nonfinite batch on one rank; checkpoints.

The ranks are spawned processes (``tests/_torch_dist_worker.py``, which
imports no JAX) in two spawns: 4 ranks for the gradients (W = 1 and 2 as
subgroups), 2 for the trainer. JAX runs on 4 forced host devices in a
subprocess, from a script this module writes to a temporary directory,
while the ranks run. Results come back as ``.npz``. The file takes about 40
s in one process; every spawn, join and collective has a time limit, so a
hang fails a test instead of the run.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.core import distributed_mgn as jdmgn
from repro.models import meshgraphnet as jmgn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import distributed_mgn as dmgn
from repro_torch.core import halo as halo_lib
from repro_torch.core import partitioning
from repro_torch.core.gradient_aggregation import padded_partition_batches
from repro_torch.core.graph_build import knn_edges
from repro_torch.launch import train as ptrain
from repro_torch.launch.sharding import shard_count_for, shard_range
from repro_torch.models import meshgraphnet as mgn
from repro_torch.models.convert import state_dict_from_jax

SRC = str(Path(__file__).resolve().parents[1] / "src")
# Loss of a step summed over ranks (or partitions) in another order than the
# full graph's: relative 1e-5. Each gradient leaf: 1e-5 of its own largest
# element (tests/_dist_check.py holds JAX's schemes to 5e-5 absolute).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
# The 4-step trajectory, as tests/test_torch_train.py: parameters to 1e-6,
# except where a gradient fell below worker.NEAR_ZERO in a step (at most
# MAX_NEAR_ZERO of the elements), whose Adam update may differ by up to
# 2 lr a step.
TRAJ_ATOL = 1e-6
MAX_NEAR_ZERO = 0.01
DDP_WORLDS = (1, 2, 4)
DMGN_WORLDS = (2, 4)
N_PARTS = 4
JAX_TIMEOUT = 240

_JAX_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import GNNConfig
from repro.core import distributed_mgn as dmgn
from repro.data import pipeline as pipe
from repro.launch.sharding import mesh_for_shards
from repro.launch.train import make_gnn_step_fn, prepare_gnn_batch
from repro.models import meshgraphnet as mgn
from repro.optim.adam import AdamConfig, adam_init
from repro_torch.models.convert import state_dict_from_jax

d = sys.argv[1]
data = dict(np.load(os.path.join(d, "grads_in.npz")))
out = {{}}


def put(prefix, loss, tree, n_layers):
    out[prefix + "_loss"] = np.asarray(loss)
    for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                    n_layers).items():
        out[prefix + "_" + k] = v.numpy()


cfg = GNNConfig(node_in=6, edge_in=4, node_out=3, hidden=32,
                n_mp_layers={layers}, halo={layers})
params = mgn.init(jax.random.PRNGKey(1), cfg)
denom = float(data["denom"])
g = {{k: data[k] for k in ("senders", "receivers", "node_feats",
                          "edge_feats", "targets")}}
full = dict(g, loss_mask=np.ones(len(data["labels4"]), np.float32))
put("full", *jax.value_and_grad(
    lambda p: mgn.loss_fn(p, cfg, full, denom=denom))(params), cfg.n_mp_layers)
stacked = {{k[len("stacked_"):]: jnp.asarray(v) for k, v in data.items()
           if k.startswith("stacked_")}}
for w in {ddp}:
    mesh = mesh_for_shards(w)
    put(f"ddp{{w}}", *dmgn.make_xmgn_ddp_grad_fn(mesh, cfg, denom)(
        params, stacked), cfg.n_mp_layers)
for w in {dmgn}:
    mesh = mesh_for_shards(w)
    shards = dmgn.prepare_dmgn_shards(
        g["senders"], g["receivers"], data[f"labels{{w}}"], w,
        g["node_feats"], g["edge_feats"], g["targets"])
    put(f"dmgn{{w}}", *dmgn.make_dmgn_grad_fn(mesh, cfg, denom)(
        params, dmgn.device_put_shards(shards, mesh)), cfg.n_mp_layers)

# the trajectory of the sharded trainer on 2 devices
tcfg = GNNConfig().reduced().replace(levels=(64, 128, 256), hidden=32,
                                     n_mp_layers=2, halo=2, n_partitions=4)
train, _, ni, no = pipe.build_dataset(tcfg, 3)
psamples = pipe.partition_samples(tcfg, train, ni, no)
mesh = mesh_for_shards(2)
step = make_gnn_step_fn(tcfg, AdamConfig(total_steps={steps}), mesh=mesh)
p, o = mgn.init(jax.random.PRNGKey(0), tcfg), None
o = adam_init(p)
losses, gnorms = [], []
for it in range({steps}):
    st, dn = prepare_gnn_batch(psamples[it % len(psamples)], mesh)
    p, o, loss, gn, skipped = step(p, o, st, dn)
    assert not bool(skipped)
    losses.append(float(loss))
    gnorms.append(float(gn))
put("traj", 0.0, p, tcfg.n_mp_layers)
with open(os.path.join(d, "jax_meta.json"), "w") as f:
    json.dump({{"traj_losses": losses, "traj_gnorms": gnorms}}, f)
np.savez(os.path.join(d, "jax.npz"), **out)
print("ALL_OK")
"""


def _graph():
    """tests/_dist_check.py's graph, from the same seed."""
    rng = np.random.default_rng(0)
    n, k = 240, 4
    pos = rng.random((n, 3)).astype(np.float32)
    s, r = knn_edges(pos, k)
    nf = rng.normal(size=(n, 6)).astype(np.float32)
    rel = pos[s] - pos[r]
    ef = np.concatenate([rel, np.linalg.norm(rel, axis=-1, keepdims=True)],
                        -1).astype(np.float32)
    tg = rng.normal(size=(n, 3)).astype(np.float32)
    return dict(pos=pos, senders=s, receivers=r, node_feats=nf,
                edge_feats=ef, targets=tg, denom=np.float32(n * 3))


def _labels(g, n_parts):
    return partitioning.partition(g["senders"], g["receivers"],
                                  len(g["pos"]), n_parts, positions=g["pos"])


def _dmgn_args(g, labels, w):
    return (g["senders"], g["receivers"], labels, w, g["node_feats"],
            g["edge_feats"], g["targets"])


def _jax_params(cfg, seed):
    return jax.tree_util.tree_map(np.asarray,
                                  jmgn.init(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's and JAX's results: the JAX subprocess runs while the
    two spawns of ranks do."""
    d = tmp_path_factory.mktemp("dist")
    g = _graph()
    cfg = worker.DIST_CFG
    labels = {w: _labels(g, w) for w in (2, 4)}
    parts = halo_lib.build_partitions(g["senders"], g["receivers"],
                                      labels[N_PARTS], N_PARTS,
                                      halo_hops=cfg.n_mp_layers)
    stacked = padded_partition_batches(halo_lib.pad_partitions(parts),
                                       g["node_feats"], g["edge_feats"],
                                       g["targets"])
    arrays = {k: v for k, v in g.items() if k != "pos"}
    arrays.update({f"labels{w}": v for w, v in labels.items()})
    arrays.update({f"stacked_{k}": v for k, v in stacked.items()})
    for w in DMGN_WORLDS:
        shards = dmgn.prepare_dmgn_shards(*_dmgn_args(g, labels[w], w))
        arrays.update({f"dmgn{w}_{k}": shards[k] for k in dmgn.SHARD_KEYS})
    np.savez(d / "grads_in.npz", **arrays)
    jcfg = JaxGNNConfig(node_in=6, edge_in=4, node_out=3, hidden=32,
                        n_mp_layers=cfg.n_mp_layers, halo=cfg.n_mp_layers)
    torch.save(state_dict_from_jax(_jax_params(jcfg, 1), cfg.n_mp_layers),
               d / "params.pt")
    tcfg = worker.TRAIN_CFG
    jtcfg = JaxGNNConfig().reduced().replace(
        levels=tcfg.levels, hidden=tcfg.hidden, n_mp_layers=tcfg.n_mp_layers,
        halo=tcfg.halo, n_partitions=tcfg.n_partitions)
    torch.save(state_dict_from_jax(_jax_params(jtcfg, 0), tcfg.n_mp_layers),
               d / "params_traj.pt")

    script = d / "jax_dist_4.py"
    script.write_text(textwrap.dedent(_JAX_SCRIPT.format(
        layers=cfg.n_mp_layers, ddp=DDP_WORLDS, dmgn=DMGN_WORLDS,
        steps=worker.TRAJ_STEPS)))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    jax_proc = subprocess.Popen([sys.executable, str(script), str(d)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        worker.spawn(4, worker.grads_job, d)
        worker.spawn(2, worker.train_job, d)
        out, err = jax_proc.communicate(timeout=JAX_TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0 and "ALL_OK" in out, \
        f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return dict(
        dir=d, graph=g, labels=labels, stacked=stacked,
        grads=[dict(np.load(d / f"grads_rank{r}.npz")) for r in range(4)],
        train=[dict(np.load(d / f"train_rank{r}.npz")) for r in range(2)],
        meta=[json.loads((d / f"train_rank{r}.json").read_text())
              for r in range(2)],
        jax=dict(np.load(d / "jax.npz")),
        jax_meta=json.loads((d / "jax_meta.json").read_text()))


@pytest.fixture(scope="module")
def full_graph(runs):
    """The port's full-graph loss and gradients on the one process."""
    g, cfg = runs["graph"], worker.DIST_CFG
    model = worker._model(runs["dir"] / "params.pt", cfg)
    batch = {k: torch.from_numpy(g[k]) for k in
             ("node_feats", "edge_feats", "senders", "receivers", "targets")}
    batch["loss_mask"] = torch.ones(len(g["pos"]))
    loss = mgn.loss_fn(model, batch, float(g["denom"]))
    loss.backward()
    return loss.item(), worker._grads(model)


def _names():
    return [n for n, _ in mgn.MeshGraphNet(worker.DIST_CFG).leaves()]


def _close_grads(got: dict, want: dict, what: str):
    for n in _names():
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= GRAD_RTOL * scale, f"{what}: {n} differs by {err} " \
            f"(largest element {scale})"


def _scheme(res: dict, prefix: str) -> dict:
    return {n: res[f"{prefix}_{n}"] for n in _names()}


def test_shard_count_and_ranges():
    """JAX's rule: the largest rank count that divides P; a rank past it
    holds no partition."""
    assert shard_count_for(21, 8) == 7
    assert shard_count_for(4, 8, limit=1) == 1
    assert shard_count_for(8, 2) == 2
    assert [shard_range(8, r, 2) for r in range(3)] == \
        [range(0, 4), range(4, 8), range(0)]
    with pytest.raises(ValueError, match="split"):
        shard_range(6, 0, 4)


@pytest.mark.parametrize("w", DMGN_WORLDS)
def test_dmgn_shards_equal_jax(w):
    """prepare_dmgn_shards gives JAX's arrays, array for array."""
    g = _graph()
    labels = _labels(g, w)
    got = dmgn.prepare_dmgn_shards(*_dmgn_args(g, labels, w))
    want = jdmgn.prepare_dmgn_shards(*_dmgn_args(g, labels, w))
    assert got["meta"] == want["meta"]
    assert sorted(got) == sorted(want)
    for k in dmgn.SHARD_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _check_scheme(runs, full_graph, prefix, w, what, jax_prefix=None):
    jax_res = runs["jax"]
    jax_prefix = jax_prefix or prefix
    ranks = runs["grads"][:w]
    loss = float(ranks[0][f"{prefix}_loss"])
    np.testing.assert_allclose(loss, float(jax_res["full_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, full_graph[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, float(jax_res[f"{jax_prefix}_loss"]),
                               rtol=LOSS_RTOL)
    got = _scheme(ranks[0], prefix)
    _close_grads(got, _scheme(jax_res, jax_prefix), f"{what} against JAX's")
    _close_grads(got, _scheme(jax_res, "full"), f"{what} against JAX full")
    _close_grads(got, full_graph[1], f"{what} against the port's full graph")
    for r, res in enumerate(ranks[1:], 1):
        for n in _names():
            np.testing.assert_array_equal(res[f"{prefix}_{n}"], got[n],
                                          err_msg=f"{what}: rank {r} {n}")


@pytest.mark.parametrize("w", DDP_WORLDS)
def test_ddp_gradients_match_jax_and_full_graph(runs, full_graph, w):
    """X-MGN partitions-as-DDP, 4 partitions over W ranks: the loss and
    every gradient leaf agree with JAX's ``make_xmgn_ddp_grad_fn`` on W
    devices and with the full graph's, and every rank holds the same
    sums."""
    _check_scheme(runs, full_graph, f"ddp{w}", w, f"DDP W={w}")


def test_ddp_ranks_without_partitions_add_zeros(runs, full_graph):
    """4 ranks, 2 of them holding the 4 partitions (as when the largest
    rank count that divides P is below the world): the 2 others join the
    one all_reduce with zeros, and the sums are JAX's on 2 devices."""
    _check_scheme(runs, full_graph, "idle", 4, "DDP 2 of 4 ranks",
                  jax_prefix="ddp2")


@pytest.mark.parametrize("w", DMGN_WORLDS)
def test_dmgn_gradients_match_jax_and_full_graph(runs, full_graph, w):
    """The baseline with its per-layer boundary exchange, one shard per
    rank: the loss and every gradient leaf agree with JAX's
    ``make_dmgn_grad_fn`` and with the full graph's (an exchange whose
    backward dropped the other ranks' gradient rows would miss every
    contribution that crosses a shard boundary)."""
    _check_scheme(runs, full_graph, f"dmgn{w}", w, f"baseline W={w}")


def test_collectives_per_step(runs):
    """One collective a DDP step, 2L + 1 a baseline step, on every rank."""
    n_layers = worker.DIST_CFG.n_mp_layers
    for r, res in enumerate(runs["grads"]):
        for w in DDP_WORLDS:
            if r < w:
                assert int(res[f"ddp{w}_collectives"]) == 1, (r, w)
        for w in DMGN_WORLDS:
            if r < w:
                assert int(res[f"dmgn{w}_collectives"]) == \
                    2 * n_layers + 1, (r, w)
    for meta in runs["meta"]:
        assert meta["traj_collectives"] == worker.TRAJ_STEPS


def _traj_names():
    return [n for n, _ in mgn.MeshGraphNet(worker.TRAIN_CFG).leaves()]


def _near_zero_close(runs, got: dict, want: dict, steps: int):
    """``got`` against ``want`` to TRAJ_ATOL, except the elements whose
    gradient fell below worker.NEAR_ZERO in a step of the 2-rank trajectory (at
    most MAX_NEAR_ZERO of them): 2 lr a step there."""
    near = {n: runs["train"][0][f"near_{n}"] for n in want}
    n_near = sum(int(m.sum()) for m in near.values())
    assert n_near <= MAX_NEAR_ZERO * sum(m.size for m in near.values())
    bound = 2 * worker.AdamConfig().lr_max * steps
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        assert diff[~near[n]].max(initial=0.0) <= TRAJ_ATOL, n
        assert diff[near[n]].max(initial=0.0) <= bound, n


def _one_process_run(runs, monkeypatch, steps, **kw):
    """train_gnn in this process on the trainer's config, from the JAX
    init."""
    monkeypatch.setattr(
        ptrain.meshgraphnet, "init",
        lambda gen, c, device=None: worker._model(
            runs["dir"] / "params_traj.pt", c))
    model, losses, _ = ptrain.train_gnn(worker.TRAIN_CFG, steps, 3,
                                        log_every=100, device="cpu", **kw)
    return {n: p.detach().numpy() for n, p in model.leaves()}, losses


def test_trajectory_matches_jax_sharded_step(runs):
    """4 steps of ``make_gnn_step_fn(group=...)`` on 2 ranks from the JAX
    init against JAX's ``make_gnn_step_fn(mesh=mesh_for_shards(2))``: the
    losses, the gradient norms and the final parameters; both ranks end
    with the same parameters, bit for bit."""
    meta, jmeta = runs["meta"][0], runs["jax_meta"]
    np.testing.assert_allclose(meta["traj_losses"], jmeta["traj_losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta["traj_gnorms"], jmeta["traj_gnorms"],
                               rtol=LOSS_RTOL)
    got = {n: runs["train"][0][f"traj_{n}"] for n in _traj_names()}
    _near_zero_close(runs, got,
                     {n: runs["jax"][f"traj_{n}"] for n in _traj_names()},
                     worker.TRAJ_STEPS)
    assert runs["meta"][1]["traj_losses"] == meta["traj_losses"]
    for n in _traj_names():
        np.testing.assert_array_equal(runs["train"][1][f"traj_{n}"], got[n])


def test_train_gnn_two_ranks_matches_one_process(runs, monkeypatch):
    """``train_gnn`` under a 2-rank group: bit-equal to the 2-rank
    trajectory of ``make_gnn_step_fn`` (the same batches in the same
    order), and against the same call in one process the losses to 1e-5
    and the parameters as the trajectory's against JAX."""
    meta = runs["meta"]
    assert meta[0]["run_losses"] == meta[0]["traj_losses"]
    assert meta[1]["run_losses"] == meta[0]["run_losses"]
    got = {n: runs["train"][0][f"run_{n}"] for n in _traj_names()}
    for n in _traj_names():
        np.testing.assert_array_equal(got[n], runs["train"][0][f"traj_{n}"])
        np.testing.assert_array_equal(runs["train"][1][f"run_{n}"], got[n])
    want, losses = _one_process_run(runs, monkeypatch, worker.TRAJ_STEPS)
    np.testing.assert_allclose(meta[0]["run_losses"], losses, rtol=LOSS_RTOL)
    _near_zero_close(runs, got, want, worker.TRAJ_STEPS)


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}/", out)
    else:
        out[prefix] = np.asarray(tree)


def test_nonfinite_on_one_rank_skips_on_both(runs):
    """A ``train.batch`` corruption on rank 1 alone in step 1: both ranks
    see the summed loss nonfinite and skip, and the checkpoint after the
    skipped step holds the parameters and Adam state of the 1-step run, bit
    for bit."""
    for meta in runs["meta"]:
        assert np.isfinite(meta["skip_losses"][0])
        assert not np.isfinite(meta["skip_losses"][1])
        assert meta["skip_losses"][0] == meta["one_losses"][0]
    d = runs["dir"]
    skip, one = ckpt.restore(str(d / "skip.msgpack")), \
        ckpt.restore(str(d / "one.msgpack"))
    assert (skip["step"], one["step"]) == (2, 1)
    for key in ("params", "opt"):
        a, b = {}, {}
        _flat(skip[key], "", a)
        _flat(one[key], "", b)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key} {k}")


def test_checkpoint_written_by_rank_0_resumes_in_one_process(runs,
                                                              monkeypatch):
    """Only rank 0 wrote checkpoints (the step-2 file and the final one of
    each run); the 2-rank step-2 file resumes in one process and takes
    steps 2 and 3 as the 2-rank run took them."""
    assert runs["meta"][1]["writes"] == []
    assert sorted(runs["meta"][0]["writes"]) == sorted(
        ["run.msgpack.step00000002", "run.msgpack", "skip.msgpack",
         "one.msgpack"])
    step2 = ckpt.retained_path(str(runs["dir"] / "run.msgpack"), 2)
    got, losses = _one_process_run(runs, monkeypatch, worker.TRAJ_STEPS,
                                   resume=step2)
    np.testing.assert_allclose(losses, runs["meta"][0]["run_losses"][2:],
                               rtol=LOSS_RTOL)
    _near_zero_close(runs, got, {n: runs["train"][0][f"run_{n}"]
                                 for n in _traj_names()}, 2)
