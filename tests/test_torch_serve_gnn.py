"""The port's GNN server on the CPU: padding buckets, microbatching, request
bookkeeping, the async double-buffered flush, background deadline serving
and checkpoint loading (the cases of ``tests/test_serve_gnn.py``, less the
JAX-only ``agg_impl`` knob). Every blocking call has a timeout."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ckpt
from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.models import meshgraphnet as jmgn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.graphx.multiscale import multiscale_edges
from repro_torch.launch.serve_gnn import (GNNServer, _level_sizes,
                                          load_gnn_checkpoint)
from repro_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These servers run tiny tensors through many small ops, which a pool
    of intra-op threads only slows when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEVELS = (64, 128, 256)


def _cfg():
    return GNNConfig().reduced().replace(levels=LEVELS)


def _server(*args, **kw):
    return GNNServer(*args, device="cpu", **kw)


def test_level_sizes_nested():
    assert _level_sizes(1024, 3) == (256, 512, 1024)
    assert _level_sizes(512, 1) == (512,)


def test_serve_three_geometries_through_buckets():
    server = _server(_cfg(), (128, 256), max_batch=2, seed=0)
    reqs = []
    for i, n_req in [(0, 100), (1, 128), (2, 200)]:
        verts, faces = geo.car_surface(geo.sample_params(i))
        reqs.append((verts, faces, n_req))
    results = server.serve(reqs)
    assert len(results) == 3
    by_id = {r.request_id: r for r in results}
    assert by_id[0].bucket == 128 and by_id[1].bucket == 128
    assert by_id[2].bucket == 256
    for r in results:
        assert r.fields.shape == (r.bucket, 4)
        assert np.isfinite(r.fields).all()
        assert r.points.shape == (r.bucket, 3)
        assert r.latency_s >= r.run_s > 0.0 and r.error is None
    rep = server.stats.report()
    assert rep["requests"] == 3
    assert rep["p95_ms"] >= rep["p50_ms"] >= 0.0
    assert rep["bucket_compiles"] == 0 and rep["cache_loads"] == 0


def test_bucket_routing_edges():
    server = _server(_cfg(), (128, 256), max_batch=2)
    assert server.bucket_for(None) == 256
    assert server.bucket_for(1) == 128
    assert server.bucket_for(128) == 128
    assert server.bucket_for(129) == 256
    assert server.bucket_for(256) == 256
    assert server.bucket_for(10_000) == 256


def test_request_exactly_at_bucket_boundary():
    server = _server(_cfg(), (128, 256), max_batch=2)
    verts, faces = geo.car_surface(geo.sample_params(0))
    [res] = server.serve([(verts, faces, 128)])
    assert res.bucket == 128 and res.fields.shape == (128, 4)
    assert np.isfinite(res.fields).all()


def test_empty_flush():
    server = _server(_cfg(), (128,), max_batch=2)
    assert server.pending() == 0
    assert server.flush() == []
    assert server.stats.report()["requests"] == 0
    assert server.stats.batch_sizes == []


def test_microbatching_caps_batch_size():
    server = _server(_cfg(), (128,), max_batch=2)
    verts, faces = geo.car_surface(geo.sample_params(0))
    for _ in range(5):
        server.submit(verts, faces, 128)
    assert server.pending() == 5
    results = server.flush()
    assert server.pending() == 0 and len(results) == 5
    assert max(r.batch_size for r in results) <= 2
    assert server.stats.batch_sizes == [2, 2, 1]


def _dense_overflow_geometry():
    """90% of the surface area in one tiny triangle + a distant second
    triangle stretching the bounding box: overflows calibrated grids."""
    verts = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 1e-3],
                      [100, 100, 100], [100.1, 100, 100],
                      [100, 100.1, 100.001]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    return verts, faces


def test_ood_geometry_overflow_warns_once():
    server = _server(_cfg(), (512,), max_batch=1)
    verts, faces = _dense_overflow_geometry()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        results = server.serve([(verts, faces, 512)] * 2)
    assert server.stats.overflow_requests == 2
    # one warning per (bucket, condition), not one per request
    assert sum("overflows" in str(c.message) for c in caught) == 1
    assert all(np.isfinite(r.fields).all() for r in results)


def test_custom_reference_geometry():
    verts, faces = geo.car_surface(geo.sample_params(5))
    server = _server(_cfg(), (128,), max_batch=1, reference=(verts, faces))
    [res] = server.serve([(verts, faces, 128)])
    assert np.isfinite(res.fields).all()
    assert server.stats.overflow_requests == 0


def test_deterministic_across_servers():
    verts, faces = geo.car_surface(geo.sample_params(3))
    outs = []
    for _ in range(2):
        server = _server(_cfg(), (128,), max_batch=1, seed=7)
        [res] = server.serve([(verts, faces, 128)])
        outs.append(res.fields)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_sampling_independent_of_traffic_and_warmup():
    verts, faces = geo.car_surface(geo.sample_params(3))
    v2, f2 = geo.car_surface(geo.sample_params(9))
    plain = _server(_cfg(), (128,), max_batch=1, seed=7)
    [r_plain] = plain.serve([(verts, faces, 128)])
    busy = _server(_cfg(), (128,), max_batch=2, seed=7)
    busy.warmup()
    busy.submit(verts, faces, 128)      # rid 0, as in `plain`
    busy.submit(v2, f2, 128)
    res = {r.request_id: r for r in busy.flush()}
    np.testing.assert_array_equal(r_plain.points, res[0].points)
    np.testing.assert_array_equal(r_plain.fields, res[0].fields)


def test_overflow_rejection_path():
    server = _server(_cfg(), (512,), max_batch=2, reject_overflow=True)
    verts, faces = _dense_overflow_geometry()
    ok_verts, ok_faces = geo.car_surface(geo.sample_params(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = server.serve([(verts, faces, 512),
                                (ok_verts, ok_faces, 512)])
    by_id = {r.request_id: r for r in results}
    assert by_id[0].error is not None and "overflow" in by_id[0].error
    assert np.isnan(by_id[0].fields).all() and by_id[0].batch_size == 0
    assert by_id[1].error is None and np.isfinite(by_id[1].fields).all()
    assert server.stats.rejected_requests == 1
    assert server.stats.overflow_requests == 1
    assert len(server.stats.latencies_s) == 1


def _mixed_requests():
    reqs = []
    for i, n in [(0, 100), (1, 256), (2, 128), (3, 64), (4, 200)]:
        verts, faces = geo.car_surface(geo.sample_params(i))
        reqs.append((verts, faces, n))
    return reqs


def test_flush_drain_order_deterministic():
    server = _server(_cfg(), (256, 128), max_batch=2, seed=0)
    results = server.serve(_mixed_requests())
    assert [r.request_id for r in results] == [0, 2, 3, 1, 4]
    assert [r.bucket for r in results] == [128, 128, 128, 256, 256]
    assert server.stats.batch_sizes == [2, 1, 2]


def test_async_flush_matches_sync_exactly():
    outs = {}
    for mode in (False, True):
        server = _server(_cfg(), (128, 256), max_batch=2, seed=7,
                         async_flush=mode)
        outs[mode] = (server.serve(_mixed_requests()),
                      server.stats.batch_sizes)
    assert outs[True][1] == outs[False][1]
    for a, b in zip(outs[True][0], outs[False][0]):
        assert a.request_id == b.request_id and a.bucket == b.bucket
        np.testing.assert_array_equal(a.fields, b.fields)


def test_async_flush_rejection_ordering():
    server = _server(_cfg(), (512,), max_batch=2, reject_overflow=True,
                     async_flush=True)
    bad_verts, bad_faces = _dense_overflow_geometry()
    ok_verts, ok_faces = geo.car_surface(geo.sample_params(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = server.serve([(bad_verts, bad_faces, 512),
                                (ok_verts, ok_faces, 512)])
    assert [r.request_id for r in results] == [0, 1]
    assert results[0].error is not None and np.isnan(results[0].fields).all()
    assert results[1].error is None and np.isfinite(results[1].fields).all()


def test_flush_mode_override_per_call():
    verts, faces = geo.car_surface(geo.sample_params(0))
    server = _server(_cfg(), (128,), max_batch=2, async_flush=True)
    server.submit(verts, faces, 128)
    [r_sync] = server.flush(async_mode=False)
    server2 = _server(_cfg(), (128,), max_batch=2, async_flush=True)
    server2.submit(verts, faces, 128)
    [r_async] = server2.flush()
    np.testing.assert_array_equal(r_sync.fields, r_async.fields)


def test_partial_batch_runs_only_real_rows():
    """No replay rows: a lone request in a max_batch=4 server runs one row
    and records no replay padding (the JAX server pads to max_batch)."""
    server = _server(_cfg(), (128,), max_batch=4, seed=0)
    verts, faces = geo.car_surface(geo.sample_params(0))
    calls = []
    b = server._buckets[128]
    infer = b.infer

    def spy(model, pts, nrm, n_valid):
        calls.append(tuple(pts.shape))
        return infer(model, pts, nrm, n_valid)

    b.infer = spy
    [res] = server.serve([(verts, faces, 100)])
    assert calls == [(1, 128, 3)]
    assert server.stats.padding_points == 128 - 100
    assert server.stats.requested_points == 100
    assert res.error is None


def test_edge_counters_sum_the_served_rows_valid_edges():
    """``edges_computed`` is the sum of the union's edge mask over the rows
    served, ``edge_slots`` their slots, and ``edge_compute_frac`` the
    ratio; warm-up rows count in neither."""
    server = _server(_cfg(), (128, 256), max_batch=2, seed=0)
    server.warmup()
    reqs = [(*geo.car_surface(geo.sample_params(i)), n)
            for i, n in [(0, 100), (1, 128), (2, 200)]]
    results = server.serve(reqs)
    valid = 0
    for res in results:
        assert res.error is None
        ms = server._buckets[res.bucket].ms
        _, _, em = multiscale_edges(torch.from_numpy(res.points),
                                    res.bucket, ms)
        valid += int(em.sum())
    slots = sum(server._buckets[res.bucket].ms.n_edges for res in results)
    st = server.stats
    assert st.edges_computed == valid and st.edge_slots == slots
    assert server.stats.report()["edge_compute_frac"] == valid / slots
    assert 0.3 < valid / slots < 0.6


def test_background_deadline_flush():
    server = _server(_cfg(), (128,), max_batch=4, seed=7)
    server.warmup()
    server.start(deadline_s=0.02)
    verts, faces = geo.car_surface(geo.sample_params(0))
    try:
        rid = server.submit(verts, faces, 128)
        res = server.result(rid, timeout=30.0)
        assert res.request_id == rid and np.isfinite(res.fields).all()
        assert res.batch_size == 1            # deadline fired, not max_batch
        rids = [server.submit(verts, faces, 128) for _ in range(4)]
        out = [server.result(r, timeout=30.0) for r in rids]
        assert all(o.batch_size == 4 for o in out)
    finally:
        server.stop()
    assert server.pending() == 0


def test_background_matches_foreground_results():
    verts, faces = geo.car_surface(geo.sample_params(3))
    plain = _server(_cfg(), (128,), max_batch=1, seed=7)
    [want] = plain.serve([(verts, faces, 128)])
    server = _server(_cfg(), (128,), max_batch=1, seed=7)
    server.start(deadline_s=0.01)
    try:
        rid = server.submit(verts, faces, 128)
        got = server.result(rid, timeout=30.0)
    finally:
        server.stop()
    np.testing.assert_array_equal(want.points, got.points)
    np.testing.assert_array_equal(want.fields, got.fields)


def test_background_result_timeout():
    server = _server(_cfg(), (128,), max_batch=1)
    with pytest.raises(TimeoutError):
        server.result(999, timeout=0.01)
    with pytest.raises(RuntimeError):
        server.start()
        server.start()
    server.stop()


def _jax_params(seed):
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    return jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_from_checkpoint_serves_trained_weights(tmp_path, writer):
    """from_checkpoint uses the checkpoint's params and its normalizer
    stats: with identity input stats and affine output stats, predictions
    are std * plain + mean. Either package's checkpoint writer."""
    cfg = _cfg()
    params = _jax_params(42)
    norm_in = {"mean": np.zeros((1, cfg.node_in), np.float32),
               "std": np.ones((1, cfg.node_in), np.float32)}
    norm_out = {"mean": np.full((1, cfg.node_out), 5.0, np.float32),
                "std": np.full((1, cfg.node_out), 2.0, np.float32)}
    path = str(tmp_path / "ckpt.msgpack")
    save = ckpt.save if writer == "torch" else jax_ckpt.save
    save(path, {"params": params, "norm_in": norm_in, "norm_out": norm_out})

    _, li, lo = load_gnn_checkpoint(path, cfg, device="cpu")
    np.testing.assert_array_equal(li[0], norm_in["mean"])
    np.testing.assert_array_equal(lo[1], norm_out["std"])

    verts, faces = geo.car_surface(geo.sample_params(4))
    plain = _server(cfg, (128,), max_batch=1, seed=7,
                    params=params_from_jax(params, cfg, device="cpu"))
    [want] = plain.serve([(verts, faces, 128)])
    served = GNNServer.from_checkpoint(path, cfg, (128,), max_batch=1,
                                       seed=7, device="cpu")
    [got] = served.serve([(verts, faces, 128)])
    np.testing.assert_allclose(got.fields, 2.0 * want.fields + 5.0,
                               rtol=1e-5, atol=1e-5)
    fresh = _server(cfg, (128,), max_batch=1, seed=7)
    [other] = fresh.serve([(verts, faces, 128)])
    assert not np.allclose(got.fields, other.fields, atol=1e-4)


def test_load_gnn_checkpoint_rejects_non_gnn(tmp_path):
    path = str(tmp_path / "bad.msgpack")
    ckpt.save(path, {"weights": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="missing 'params'"):
        load_gnn_checkpoint(path, _cfg(), device="cpu")


def test_flush_refused_while_background_worker_runs():
    server = _server(_cfg(), (128,), max_batch=2)
    server.start(deadline_s=10.0)
    verts, faces = geo.car_surface(geo.sample_params(0))
    try:
        server.submit(verts, faces, 128)
        with pytest.raises(RuntimeError, match="background worker"):
            server.flush()
        with pytest.raises(RuntimeError, match="background worker"):
            server.serve([(verts, faces, 128)])
    finally:
        server.stop()


def test_background_result_buffer_bounded():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    server.warmup()
    server.start(deadline_s=0.005, result_cap=2)
    verts, faces = geo.car_surface(geo.sample_params(0))
    try:
        rids = [server.submit(verts, faces, 128) for _ in range(4)]
        server.result(rids[-1], timeout=60.0)
    finally:
        server.stop()
    assert len(server._done) <= 2
    with pytest.raises(TimeoutError):
        server.result(rids[0], timeout=0.01)   # evicted


def test_background_worker_survives_bad_request():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    server.warmup()
    server.start(deadline_s=0.005)
    verts, faces = geo.car_surface(geo.sample_params(0))
    bad_faces = np.array([[0, 1, 10_000_000]])   # out-of-range vertex id
    try:
        bad = server.submit(verts, bad_faces, 128)
        res = server.result(bad, timeout=60.0)
        assert res.error is not None and "serving error" in res.error
        good = server.submit(verts, faces, 128)
        ok = server.result(good, timeout=60.0)
        assert ok.error is None and np.isfinite(ok.fields).all()
    finally:
        server.stop()


def test_serve_guard_runs_before_submitting():
    server = _server(_cfg(), (128,), max_batch=4)
    server.start(deadline_s=30.0)
    verts, faces = geo.car_surface(geo.sample_params(0))
    try:
        with pytest.raises(RuntimeError, match="background worker"):
            server.serve([(verts, faces, 128)])
        assert server.pending() == 0
    finally:
        server.stop()


def test_background_worker_isolates_failures_per_batch():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    server.warmup()
    verts, faces = geo.car_surface(geo.sample_params(0))
    bad = server.submit(verts, np.array([[0, 1, 10_000_000]]), 128)
    good = server.submit(verts, faces, 128)
    server.start(deadline_s=0.005)
    try:
        ok = server.result(good, timeout=60.0)
        err = server.result(bad, timeout=60.0)
    finally:
        server.stop()
    assert err.error is not None and "serving error" in err.error
    assert ok.error is None and np.isfinite(ok.fields).all()
