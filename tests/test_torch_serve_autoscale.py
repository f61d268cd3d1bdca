"""The port's autoscaling padding buckets on the CPU: the traffic-derived
ladder, the bucket cache (LRU eviction + rebuild), oversize-request
semantics, the hit/miss/calibration accounting and thread-safe
introspection (the cases of ``tests/test_autoscale_buckets.py``, less the
sharded one). The JAX server's compile counts map to ``bucket_misses`` and
``bucket_calibrations``: the port compiles no program per bucket, so
``bucket_compiles`` stays 0."""
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.models import meshgraphnet as jmgn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.launch.serve_gnn import GNNServer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These servers run tiny tensors through many small ops, which a pool
    of intra-op threads only slows when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return GNNConfig().reduced().replace(levels=(64, 128, 256), **kw)


def _server(*args, **kw):
    return GNNServer(*args, device="cpu", **kw)


def _geom(i=0):
    return geo.car_surface(geo.sample_params(i))


def test_auto_ladder_matches_static_ladder_exactly():
    verts, faces = _geom(0)
    static = _server(_cfg(), (128,), max_batch=1, seed=5)
    [want] = static.serve([(verts, faces, 128)])
    auto = _server(_cfg(bucket_granularity=64), "auto", max_batch=1, seed=5)
    [got] = auto.serve([(verts, faces, 128)])
    assert got.bucket == 128 and auto.ladder() == (128,)
    np.testing.assert_array_equal(want.points, got.points)
    np.testing.assert_array_equal(want.fields, got.fields)


def test_auto_oversize_grows_bucket_never_truncates():
    verts, faces = _geom(0)
    server = _server(_cfg(bucket_granularity=64), "auto", max_batch=1,
                     seed=0)
    [small] = server.serve([(verts, faces, 64)])
    assert small.bucket == 64
    [big] = server.serve([(verts, faces, 200)])
    assert big.bucket == 256 and big.fields.shape == (256, 4)
    assert np.isfinite(big.fields).all()
    rep = server.stats.report()
    assert rep["grown_buckets"] == 2 and rep["oversize_requests"] == 0
    assert server.ladder() == (64, 256)


def test_static_oversize_warns_and_counts():
    verts, faces = _geom(0)
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        [res] = server.serve([(verts, faces, 10_000)])
        server.serve([(verts, faces, 20_000)])
    assert res.bucket == 128 and res.error is None
    # warn-once per ladder max: two oversize asks, one warning
    assert sum("DOWNSAMPLED" in str(c.message) for c in caught) == 1
    assert server.stats.report()["oversize_requests"] == 2


def test_static_oversize_rejected_under_reject_overflow():
    verts, faces = _geom(0)
    server = _server(_cfg(), (128,), max_batch=2, seed=0,
                     reject_overflow=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = server.serve([(verts, faces, 500), (verts, faces, 100)])
    by_id = {r.request_id: r for r in results}
    assert by_id[0].error is not None and "exceeds" in by_id[0].error
    assert np.isnan(by_id[0].fields).all()
    assert by_id[1].error is None and np.isfinite(by_id[1].fields).all()
    rep = server.stats.report()
    assert rep["oversize_requests"] == 1 and rep["rejected_requests"] == 1


def test_auto_bootstrap_default_resolution():
    server = _server(_cfg(bucket_granularity=64), "auto")
    assert server.bucket_for(None) == 1024
    assert server.bucket_for(5000) == 5056
    assert server.ladder() == () and server.target_ladder() == ()
    assert server.stats.report()["grown_buckets"] == 0


def test_bucket_for_pure_on_static_ladder():
    server = _server(_cfg(), (128,), max_batch=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(3):
            assert server.bucket_for(10_000) == 128
    assert server.stats.report()["oversize_requests"] == 0


def test_bucket_policy_validated():
    with pytest.raises(ValueError, match="bucket_policy"):
        _server(_cfg(bucket_policy="bogus"), (64,))
    with pytest.raises(ValueError, match="at least one bucket"):
        _server(_cfg(), ())


def test_seeded_auto_ladder_via_config_policy():
    verts, faces = _geom(0)
    cfg = _cfg(bucket_policy="auto", bucket_granularity=64)
    server = _server(cfg, (64,), max_batch=1, seed=0)
    assert server.auto and server.ladder() == (64,)
    [res] = server.serve([(verts, faces, 128)])
    assert res.bucket == 128 and server.ladder() == (64, 128)


def test_evict_then_rebuild_roundtrip_exact():
    """Cache capped at 2: a third bucket evicts the coldest; traffic back at
    the evicted size rebuilds it from the calibration cache (no host
    recalibration) and reproduces the static ladder's answer exactly."""
    verts, faces = _geom(0)
    sizes = [64, 128, 192, 64]
    static = _server(_cfg(), (64, 128, 192), max_batch=1, seed=9)
    want = [static.serve([(verts, faces, n)])[0] for n in sizes]
    auto = _server(_cfg(bucket_granularity=64, max_live_buckets=2), "auto",
                   max_batch=1, seed=9)
    got = [auto.serve([(verts, faces, n)])[0] for n in sizes]
    for a, b in zip(want, got):
        assert a.request_id == b.request_id and a.bucket == b.bucket
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.fields, b.fields)
    rep = auto.stats.report()
    assert rep["bucket_evictions"] == 2        # 64 evicted, then 128
    assert rep["bucket_misses"] == 4           # 3 builds + the 64 rebuild
    assert rep["bucket_calibrations"] == 3     # the rebuild recalibrates not
    assert rep["bucket_compiles"] == 0 and rep["bucket_hits"] == 0
    assert len(auto.ladder()) <= 2 and 64 in auto.ladder()


def test_eviction_spares_buckets_in_the_active_plan():
    verts, faces = _geom(0)
    cfg = _cfg(bucket_granularity=64, max_live_buckets=1)
    server = _server(cfg, "auto", max_batch=1, seed=0)
    server.serve([(verts, faces, 128)])
    server._plan_sizes = {128}
    server._ensure_bucket(64)
    assert server.ladder() == (64, 128)
    assert server.stats.report()["bucket_evictions"] == 0
    server._plan_sizes = set()
    server._ensure_bucket(192)
    assert server.stats.report()["bucket_evictions"] == 2
    assert server.ladder() == (192,)


def test_undersize_traffic_reuses_live_bucket():
    verts, faces = _geom(0)
    server = _server(_cfg(bucket_granularity=64), "auto", max_batch=1,
                     seed=0)
    server.serve([(verts, faces, 128)])
    [res] = server.serve([(verts, faces, 50)])
    assert res.bucket == 128
    rep = server.stats.report()
    assert rep["bucket_misses"] == 1 and rep["bucket_hits"] == 1
    assert rep["padding_waste_frac"] > 0.0
    assert server.stats.padding_points == 128 - 50


def test_quantile_refit_adds_tighter_bucket():
    verts, faces = _geom(0)
    cfg = _cfg(bucket_granularity=8, bucket_refit_every=4,
               bucket_quantiles=(0.5,))
    server = _server(cfg, "auto", max_batch=2, seed=0)
    server.serve([(verts, faces, 256)])
    for _ in range(8):                         # refit fires at submit #4
        server.submit(verts, faces, 40)
    results = server.flush()
    assert {r.bucket for r in results} == {40, 256}
    assert 40 in server.target_ladder()
    late = [r for r in results if r.bucket == 40]
    assert len(late) == 5
    assert all(np.isfinite(r.fields).all() for r in late)


def test_warmup_builds_nothing_new():
    """warmup() runs the live buckets (twice is harmless): no cache misses,
    one calibration per size, and later traffic hits."""
    server = _server(_cfg(), (64, 128), max_batch=1, seed=0)
    server.warmup()
    server.warmup()
    rep = server.stats.report()
    assert rep["bucket_misses"] == 0 and rep["bucket_calibrations"] == 2
    assert rep["bucket_compiles"] == 0 and rep["requests"] == 0
    verts, faces = _geom(0)
    server.serve([(verts, faces, 64)])
    assert server.stats.report()["bucket_hits"] == 1
    assert server._buckets[64].served == 1


def test_served_counter_via_traffic():
    verts, faces = _geom(0)
    server = _server(_cfg(), (64,), max_batch=1, seed=0)
    server.serve([(verts, faces, 64)])
    server.serve([(verts, faces, 64)])
    b = server._buckets[64]
    assert b.served == 2
    rep = server.stats.report()
    assert rep["bucket_hits"] == 2 and rep["bucket_misses"] == 0
    assert rep["bucket_calibrations"] == 1


def test_stats_and_pending_safe_under_background_worker():
    """``pending()``, ``report()`` and ``health()`` snapshot under locks
    while the worker mutates. The poller pauses 1 ms between rounds: the
    port's eager CPU path hands the GIL back at every torch op, and a thread
    spinning without a pause starves it: a request then takes seconds,
    not milliseconds."""
    verts, faces = _geom(0)
    server = _server(_cfg(), (64,), max_batch=2, seed=0)
    server.warmup()
    server.start(deadline_s=0.005)
    n_req = 10
    stop = threading.Event()
    failures = []

    def hammer():
        while not stop.is_set():
            try:
                rep = server.stats.report()
                assert rep["requests"] >= 0 and server.pending() >= 0
                assert server.health()["queue_depth"] >= 0
                time.sleep(1e-3)
            except Exception as e:          # pragma: no cover - regression
                failures.append(e)
                return

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        rids = [server.submit(verts, faces, 64) for _ in range(n_req)]
        results = [server.result(r, timeout=60.0) for r in rids]
    finally:
        stop.set()
        t.join(timeout=10.0)
        server.stop()
    assert not failures
    assert all(r.error is None for r in results)
    assert server.stats.report()["requests"] == n_req
    assert server.pending() == 0


def test_auto_with_background_worker():
    verts, faces = _geom(0)
    server = _server(_cfg(bucket_granularity=64), "auto", max_batch=2,
                     seed=0)
    server.start(deadline_s=0.005)
    try:
        small = server.submit(verts, faces, 64)
        big = server.submit(verts, faces, 180)     # grows a 192 bucket
        r_small = server.result(small, timeout=120.0)
        r_big = server.result(big, timeout=120.0)
    finally:
        server.stop()
    assert r_small.bucket == 64 and r_big.bucket == 192
    assert np.isfinite(r_small.fields).all()
    assert np.isfinite(r_big.fields).all()
    assert server.ladder() == (64, 192)


def test_from_checkpoint_accepts_auto(tmp_path):
    jcfg = JaxGNNConfig().reduced().replace(levels=(64, 128, 256))
    params = jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(1), jcfg))
    path = str(tmp_path / "ckpt.msgpack")
    ckpt.save(path, {"params": params})
    server = GNNServer.from_checkpoint(path, _cfg(), "auto", max_batch=1,
                                       seed=3, device="cpu")
    verts, faces = _geom(0)
    [res] = server.serve([(verts, faces, 64)])
    assert res.bucket == 64 and np.isfinite(res.fields).all()
    assert server.auto and server.ladder() == (64,)
