"""The port's sharded serving (``repro_torch.graphx.sharded``, the server's
``shard_devices`` and the rollout engine's sharded branch) on the CPU,
against the JAX package.

Size, as ``tests/test_sharded_serving.py``: levels (64, 128, 256), k = 4,
halo 3 and ``GNNConfig().reduced()`` (3 layers, hidden 64). Plans are host
numpy in both packages and held array for array. Fields: the port's sharded
path against JAX's single-device ``make_infer_fn`` within 1e-4 on every
point (the end-to-end tolerance of the port's parity tests; JAX's own suite
holds its sharded path to its unsharded one at 1e-5), against the port's
unsharded pipeline within 1e-5, and ``halo_hops = L - 1`` must fail, as in
JAX's suite. JAX's sharded program and its sharded server need several
devices: they run on 4 forced host devices in a subprocess whose script the
module writes into a temporary directory; its results come back as files.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.graphx import hashgrid as jhash
from repro.graphx import sharded as jsharded
from repro.graphx.multiscale import MultiscaleSpec as JaxMS
from repro.graphx.multiscale import multiscale_edges as jax_edges
from repro.graphx.pipeline import make_infer_fn as jax_infer_fn
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.core import halo
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.graphx import hashgrid, sharded
from repro_torch.graphx.multiscale import MultiscaleSpec, multiscale_edges
from repro_torch.graphx.pipeline import make_infer_fn
from repro_torch.launch.serve_gnn import GNNServer
from repro_torch.models.convert import params_from_jax
from repro_torch.resilience import FAULTS

LEVELS, K, HALO = (64, 128, 256), 4, 3
JAX_ATOL = 1e-4       # against the JAX package
PORT_ATOL = 1e-5      # against the port's own unsharded path
PLAN_KEYS = ("global_ids", "hop", "owned", "level_counts", "points",
             "normals")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors through many small ops: a pool of intra-op threads only
    slows them when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, car):
    verts, faces = geo.car_surface(geo.sample_params(car))
    return sample_surface(verts, faces, n, np.random.default_rng(car))


def _cfgs(**kw):
    return (JaxGNNConfig().reduced().replace(levels=LEVELS, k_neighbors=K,
                                             **kw),
            GNNConfig().reduced().replace(levels=LEVELS, k_neighbors=K, **kw))


@pytest.fixture(scope="module")
def case():
    """Car 1 at 256 points, both packages' calibrated specs, the same
    params, and both packages' single-device fields."""
    jcfg, cfg = _cfgs()
    pts, nrm = _cloud(LEVELS[-1], 1)
    jms = JaxMS(LEVELS, K, tuple(jhash.calibrate_spec(pts[:m], K, n_points=m)
                                 for m in LEVELS))
    ms = MultiscaleSpec(LEVELS, K, tuple(
        hashgrid.calibrate_spec(pts[:m], K, n_points=m) for m in LEVELS))
    params = jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(1), jcfg))
    model = params_from_jax(params, cfg, device="cpu")
    want = np.asarray(jax_infer_fn(jcfg, jms)(
        params, jnp.asarray(pts), jnp.asarray(nrm), LEVELS[-1]))
    port = make_infer_fn(cfg, ms)(model, torch.from_numpy(pts),
                                  torch.from_numpy(nrm), LEVELS[-1]).numpy()
    return dict(cfg=cfg, pts=pts, nrm=nrm, jms=jms, ms=ms, model=model,
                want=want, port=port,
                width=sharded.global_halo_width(pts, ms))


def _plans(case, n_shards, method, halo_hops=HALO):
    kw = {"halo_width": case["width"]} if method == "geometric" else {}
    args = (case["pts"], case["nrm"], n_shards, halo_hops, LEVELS, K)
    return (jsharded.plan_shards(*args, method=method, **kw),
            sharded.plan_shards(*args, method=method, **kw))


def _run(case, plan):
    out = sharded.make_sharded_infer_fn(case["cfg"], plan.spec,
                                        device="cpu")(
        case["model"], plan.batch("cpu"))
    return plan.gather(out.numpy())


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("method", ["graph", "geometric"])
def test_plans_equal_jax(case, method, n_shards):
    """Both planners, array for array, and equal spec signatures."""
    jplan, plan = _plans(case, n_shards, method)
    for key in PLAN_KEYS:
        np.testing.assert_array_equal(getattr(plan, key),
                                      getattr(jplan, key), err_msg=key)
    assert plan.n_global == jplan.n_global
    assert plan.spec.signature() == jplan.spec.signature()
    assert (plan.hop[plan.owned] == 0).all()
    assert int(plan.owned.sum()) == LEVELS[-1]


def test_halo_width_and_bucket_spec_equal_jax(case):
    """``global_halo_width`` and ``shard_spec_for`` (the server's per-bucket
    spec) give JAX's numbers; the point-shard export equals JAX's."""
    assert case["width"] == jsharded.global_halo_width(case["pts"],
                                                       case["jms"])
    kw = dict(reference_points=case["pts"], reference_normals=case["nrm"],
              level_sizes=LEVELS, k=K)
    spec = sharded.shard_spec_for(256, 4, HALO, 1.3, **kw)
    assert spec.signature() == jsharded.shard_spec_for(
        256, 4, HALO, 1.3, **kw).signature()
    assert spec.halo_width > 0
    with pytest.raises(ValueError, match="bucket_size"):
        sharded.shard_spec_for(128, 4, HALO, 1.3, **kw)
    from repro.core import halo as jhalo
    assert halo.HOP_PAD == jhalo.HOP_PAD
    s, r = np.arange(10) % 7, (np.arange(10) * 3) % 7
    labels = np.arange(7) % 2
    got = halo.export_point_shards(halo.build_partitions(s, r, labels, 2, 2))
    want = jhalo.export_point_shards(jhalo.build_partitions(s, r, labels, 2,
                                                            2))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_per_level_counts_equal_jax_edges(case):
    """``multiscale_edges`` with one valid count per level (each shard's
    slice of a level is its own prefix) builds JAX's edges with the vector
    ``n_valid``; the scalar form is the vector of nested prefixes; a wrong
    length raises, as in JAX."""
    jplan, plan = _plans(case, 4, "graph")
    ms = plan.spec.ms
    edges = jax.jit(lambda pts, counts: jax_edges(pts, counts,
                                                  jplan.spec.ms))
    for p in range(4):
        counts = plan.level_counts[p]
        # a shard's counts are not the nested prefixes of one count
        assert counts.tolist() != [min(int(counts[-1]), n) for n in LEVELS]
        want = edges(jnp.asarray(plan.points[p]), jnp.asarray(counts))
        got = multiscale_edges(torch.from_numpy(plan.points[p]),
                               counts.tolist(), ms)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts = torch.from_numpy(case["pts"])
    scalar = multiscale_edges(pts, 100, case["ms"])
    vector = multiscale_edges(pts, [min(100, n) for n in LEVELS], case["ms"])
    for a, b in zip(scalar, vector):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="levels"):
        multiscale_edges(pts, [1, 2], case["ms"])


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("method", ["graph", "geometric"])
def test_sharded_fields_match_unsharded(case, method, n_shards):
    """Sharded fields on every point: within 1e-4 of JAX's single-device
    pipeline and 1e-5 of the port's."""
    _, plan = _plans(case, n_shards, method)
    got = _run(case, plan)
    np.testing.assert_allclose(got, case["want"], atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, case["port"], atol=PORT_ATOL, rtol=0)


def test_insufficient_halo_breaks_equivalence(case):
    """h = L - 1 halos (the paper: the halo must be as deep as the layers)."""
    _, plan = _plans(case, 4, "graph", halo_hops=HALO - 1)
    assert float(np.abs(_run(case, plan) - case["port"]).max()) > 1e-4


def test_pack_plans_lanes_equal_solo(case):
    """A packed call (the server's ``max_batch > 1``) runs only its real
    geometries, each lane equal to its solo call; a pack wider than the
    call's width and mixed specs are refused."""
    cfg = case["cfg"]
    spec = sharded.shard_spec_for(
        256, 2, HALO, 1.5, reference_points=case["pts"],
        reference_normals=case["nrm"], level_sizes=LEVELS, k=K)
    plans = [sharded.plan_shards(*_cloud(256, car), 2, HALO, LEVELS, K,
                                 method="geometric", spec=spec)
             for car in (2, 3)]
    pack = sharded.pack_plans(plans, width=3)
    batch = pack.batch("cpu")
    assert tuple(batch["points"].shape) == (2, 2, spec.n_points, 3)
    packed = sharded.make_sharded_infer_fn(cfg, spec, pack_width=3,
                                           device="cpu")(case["model"], batch)
    solo = sharded.make_sharded_infer_fn(cfg, spec, device="cpu")
    for plan, got in zip(plans, pack.gather(packed.numpy())):
        want = plan.gather(solo(case["model"], plan.batch("cpu")).numpy())
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="width"):
        sharded.pack_plans(plans, width=1)
    with pytest.raises(ValueError, match="pack width"):
        sharded.make_sharded_infer_fn(cfg, spec, pack_width=1,
                                      device="cpu")(case["model"], batch)


# ------------------------------------------------ JAX on 4 host devices

_JAX4_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs.base import GNNConfig
from repro.core.graph_build import sample_surface
from repro.data import geometry as geo
from repro.graphx import hashgrid, sharded
from repro.graphx.multiscale import MultiscaleSpec
from repro.launch.serve_gnn import GNNServer
from repro.launch.sharding import mesh_for_shards, shard_put
from repro.models import meshgraphnet
from repro.resilience.faults import FAULTS

out_dir = sys.argv[1]
levels, k, h = {levels}, {k}, {halo}
cfg = GNNConfig().reduced().replace(levels=levels, k_neighbors=k)
verts, faces = geo.car_surface(geo.sample_params(1))
pts, nrm = sample_surface(verts, faces, levels[-1],
                          np.random.default_rng(1))
ms = MultiscaleSpec(levels, k, tuple(
    hashgrid.calibrate_spec(pts[:m], k, n_points=m) for m in levels))
params = meshgraphnet.init(jax.random.PRNGKey(1), cfg)
mesh = mesh_for_shards(4)
arrays = {{}}
for method in ("graph", "geometric"):
    kw = ({{"halo_width": sharded.global_halo_width(pts, ms)}}
          if method == "geometric" else {{}})
    plan = sharded.plan_shards(pts, nrm, 4, h, levels, k, method=method,
                               **kw)
    fn = sharded.make_sharded_infer_fn(cfg, plan.spec, mesh)
    arrays["infer_" + method] = plan.gather(np.asarray(
        fn(params, shard_put(plan.batch(), mesh))))

# the server: one traffic, then a shard.plan fault on a batch's first plan
scfg = GNNConfig().reduced().replace(levels=levels)
server = GNNServer(scfg, (128, 256), max_batch=2, seed=3, shard_devices=4)
cars = [geo.car_surface(geo.sample_params(i)) for i in range(6)]
results = server.serve([(*cars[1], 100), (*cars[2], 256), (*cars[3], 128)])
FAULTS.arm("shard.plan", mode="raise", nth=1, times=1)
try:
    results += server.serve([(*cars[4], 128), (*cars[5], 120)])
finally:
    FAULTS.reset()
meta = []
for r in results:
    arrays[f"points_{{r.request_id}}"] = np.asarray(r.points)
    arrays[f"fields_{{r.request_id}}"] = np.asarray(r.fields)
    meta.append(dict(rid=r.request_id, bucket=r.bucket,
                     batch_size=r.batch_size, error=r.error))
rep = server.stats.report()
stats = {{key: rep[key] for key in (
    "requests", "rejected_requests", "bucket_calibrations", "bucket_hits",
    "bucket_misses", "quarantined_buckets")}}
stats["padding_points"] = server.stats.padding_points
stats["requested_points"] = server.stats.requested_points
stats["signatures"] = {{str(n): repr(s.signature())
                       for n, s in server._shard_calib.items()}}
np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
with open(os.path.join(out_dir, "meta.json"), "w") as f:
    json.dump(dict(results=meta, stats=stats), f)
print("ALL_OK")
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    """JAX's sharded program and sharded server on 4 forced host devices
    (the device count is fixed at JAX's first use, so not in this
    process)."""
    d = tmp_path_factory.mktemp("jax4")
    script = d / "jax_sharded_4.py"
    script.write_text(textwrap.dedent(_JAX4_SCRIPT.format(
        levels=LEVELS, k=K, halo=HALO)))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(script), str(d)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0 and "ALL_OK" in proc.stdout, \
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with np.load(d / "arrays.npz") as f:
        arrays = dict(f)
    return arrays, json.loads((d / "meta.json").read_text())


@pytest.mark.parametrize("method", ["graph", "geometric"])
def test_sharded_infer_matches_jax_on_4_devices(case, jax4, method):
    """The port's 4 shards in a row against JAX's ``shard_map`` over 4
    devices, on every point."""
    _, plan = _plans(case, 4, method)
    np.testing.assert_allclose(_run(case, plan), jax4[0]["infer_" + method],
                               atol=JAX_ATOL, rtol=0)


def _sharded_server(**kw):
    cfg = GNNConfig().reduced().replace(levels=LEVELS)
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    params = jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(3), jcfg))
    return GNNServer(cfg, (128, 256), max_batch=2, seed=3, device="cpu",
                     params=params_from_jax(params, cfg, device="cpu"),
                     **kw)


def test_sharded_server_matches_jax_server(jax4):
    """``shard_devices=4`` on one traffic and a ``shard.plan`` fault against
    the JAX server: equal ids, buckets, batch sizes and errors, bit-equal
    points, fields within 1e-4, equal counters and spec signatures. The
    fault rejects its request only; its batch neighbour is served. The JAX
    server pads a partial pack with replay lanes and counts them in
    ``padding_points``; the port runs only real geometries."""
    arrays, meta = jax4
    server = _sharded_server(shard_devices=4)
    server.batches = []
    harvest = server._harvest

    def recording(fl):
        if fl.host is not None and fl.record:
            server.batches.append((fl.bucket.n_points, len(fl.ok_reqs)))
        return harvest(fl)
    server._harvest = recording
    cars = [geo.car_surface(geo.sample_params(i)) for i in range(6)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = server.serve([(*cars[1], 100), (*cars[2], 256),
                                (*cars[3], 128)])
        FAULTS.arm("shard.plan", mode="raise", nth=1, times=1)
        try:
            results += server.serve([(*cars[4], 128), (*cars[5], 120)])
        finally:
            FAULTS.reset()
    assert [(r.request_id, r.bucket, r.batch_size, r.error)
            for r in results] == [(m["rid"], m["bucket"], m["batch_size"],
                                   m["error"]) for m in meta["results"]]
    for r in results:
        np.testing.assert_array_equal(r.points,
                                      arrays[f"points_{r.request_id}"])
        want = arrays[f"fields_{r.request_id}"]
        assert r.fields.shape == want.shape
        if r.error is None:
            np.testing.assert_allclose(r.fields, want, atol=JAX_ATOL, rtol=0)
        else:
            assert "injected fault" in r.error and np.isnan(r.fields).all()
    assert sum(r.error is not None for r in results) == 1
    rep, jstats = server.stats.report(), meta["stats"]
    for key in ("requests", "rejected_requests", "bucket_calibrations",
                "bucket_hits", "bucket_misses", "quarantined_buckets"):
        assert rep[key] == jstats[key], key
    assert server.stats.requested_points == jstats["requested_points"]
    replay = sum((server.max_batch - k) * n for n, k in server.batches)
    assert jstats["padding_points"] - server.stats.padding_points == replay
    assert {str(n): repr(s.signature())
            for n, s in server._shard_calib.items()} == jstats["signatures"]


def test_sharded_server_matches_unsharded_server_and_rebuilds():
    """The port's sharded server against its unsharded server on the same
    traffic (1e-5); an evicted sharded bucket comes back with the same
    signature and no new calibration, and a bucket built for a stale spec
    is rebuilt against the size's current one."""
    cars = [geo.car_surface(geo.sample_params(i)) for i in range(3)]
    reqs = [(*cars[0], 100), (*cars[1], 256), (*cars[2], 128)]
    want = _sharded_server().serve(reqs)
    server = _sharded_server(shard_devices=2)
    got = server.serve(reqs)
    for g, w in zip(got, want):
        assert g.error is None and g.request_id == w.request_id
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_allclose(g.fields, w.fields, atol=PORT_ATOL,
                                   rtol=0)
    assert server._buckets[128].plan_sig == \
        server._shard_calib[128].signature()
    calibrations = server.stats.bucket_calibrations
    assert calibrations == 4                  # one ms + one spec per size
    # a stale plan: the cached spec changed under a live bucket
    old = server._buckets[128]
    server._shard_calib[128] = sharded.ShardSpec(
        n_shards=2, halo_hops=3, ms=old.sspec.ms, halo_width=1e3)
    rebuilt = server._ensure_bucket(128)
    assert rebuilt is not old and rebuilt.sspec.halo_width == 1e3
    assert server.stats.bucket_calibrations == calibrations


# ------------------------------------------------ the rollout engine

def _rollouts(shard_devices, cfg, steps, clouds):
    verts, faces = geo.car_surface(geo.sample_params(0))
    srv = GNNServer(cfg, (128,), max_batch=1, seed=7, device="cpu",
                    shard_devices=shard_devices)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = srv.rollout_engine()
    rids = [eng.submit(verts, faces, 128, steps=steps, cloud=c)
            for c in clouds]
    eng.run_until_complete()
    res = [eng.result(rid) for rid in rids]
    assert all(r.error is None and r.steps_done == steps for r in res)
    return res, eng, caught


@pytest.mark.parametrize("state_feats", [False, True])
def test_sharded_rollouts_match_unsharded(state_feats):
    """Two rollouts sharing one sharded slot table (4 shards) against the
    port's unsharded engine, each within 1e-5. Without state feedback the
    flushes take 4 steps; with it the engine clamps to one step a flush,
    with a warning, and re-scatters the gathered state between flushes."""
    cfg = GNNConfig().reduced().replace(
        levels=LEVELS, rollout_slots=2, rollout_integrator="residual",
        rollout_steps_per_flush=4, rollout_state_feats=state_feats)
    clouds = [_cloud(128, car) for car in (2, 3)]
    steps = 5
    want, _, _ = _rollouts(1, cfg, steps, clouds)
    got, eng, caught = _rollouts(4, cfg, steps, clouds)
    clamped = [str(w.message) for w in caught if "clamping" in str(w.message)]
    assert eng.steps_per_flush == (1 if state_feats else 4)
    assert len(clamped) == int(state_feats)
    assert float(np.abs(want[0].fields).max()) > 1e-3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_allclose(g.fields, w.fields, atol=PORT_ATOL, rtol=0)
    assert eng.table_bytes()[128] > 0


def test_sharded_rollout_plan_fault_fails_that_rollout_only():
    """A ``shard.plan`` fault at insert fails its rollout; the next one is
    served."""
    cfg = GNNConfig().reduced().replace(levels=LEVELS, rollout_slots=2,
                                        rollout_integrator="residual")
    verts, faces = geo.car_surface(geo.sample_params(0))
    srv = GNNServer(cfg, (128,), max_batch=1, seed=7, device="cpu",
                    shard_devices=2)
    eng = srv.rollout_engine()
    FAULTS.arm("shard.plan", mode="raise", nth=1, times=1)
    try:
        bad = eng.submit(verts, faces, 128, steps=2)
        ok = eng.submit(verts, faces, 128, steps=2)
        eng.run_until_complete()
    finally:
        FAULTS.reset()
    assert "prefill/insert failed" in eng.result(bad).error
    res = eng.result(ok)
    assert res.error is None and np.isfinite(res.fields).all()
