"""Chaos and telemetry tests of the port's GNN server on the CPU (the serving
cases of ``tests/test_resilience.py`` and ``tests/test_telemetry.py``).

Invariants under injected faults: no ``result()`` waiter hangs past its
timeout; every submitted request ends in exactly one ``Result``; the server
keeps serving after a worker crash, a bucket failure or a NaN output; and
untouched requests match a fault-free run.
"""
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.launch.serve_gnn import SERVE_STAGES, GNNServer, ServerStats
from repro_torch.resilience import FAULTS, FaultError
from repro_torch.telemetry import NULL_TRACER, check_well_nested


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These servers run tiny tensors through many small ops, which a pool
    of intra-op threads only slows when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _cfg(**kw):
    return GNNConfig().reduced().replace(levels=(64, 128, 256), **kw)


def _server(*args, **kw):
    return GNNServer(*args, device="cpu", **kw)


def _geom(i=0):
    return geo.car_surface(geo.sample_params(i))


# ---------------------------------------------------------------------------
# deadlines / admission control
# ---------------------------------------------------------------------------

def test_request_deadline_expires_before_device_work():
    server = _server(_cfg(), (128,), max_batch=2, seed=0)
    verts, faces = _geom()
    calls = []
    infer = server._buckets[128].infer
    server._buckets[128].infer = \
        lambda *a: calls.append(a[1].shape[0]) or infer(*a)
    rid = server.submit(verts, faces, 128, timeout_s=0.01)
    time.sleep(0.05)
    fresh = server.submit(verts, faces, 128)
    results = {r.request_id: r for r in server.flush()}
    assert results[rid].error is not None
    assert "deadline exceeded" in results[rid].error
    assert results[rid].batch_size == 0
    assert results[fresh].error is None
    assert np.isfinite(results[fresh].fields).all()
    assert calls == [1]                       # the expired request never ran
    assert server.stats.timed_out_requests == 1
    assert server.stats.report()["timed_out_requests"] == 1


def test_server_level_default_timeout():
    server = _server(_cfg(), (128,), max_batch=2, request_timeout_s=0.01)
    verts, faces = _geom()
    rid = server.submit(verts, faces, 128)
    time.sleep(0.05)
    [res] = server.flush()
    assert res.request_id == rid and "deadline exceeded" in res.error


def test_background_worker_wakes_for_request_deadline():
    server = _server(_cfg(), (128,), max_batch=4, seed=0)
    server.warmup()
    server.start(deadline_s=30.0)
    verts, faces = _geom()
    try:
        rid = server.submit(verts, faces, 128, timeout_s=0.05)
        t0 = time.perf_counter()
        res = server.result(rid, timeout=10.0)
        assert time.perf_counter() - t0 < 5.0
        assert res.error is not None and "deadline exceeded" in res.error
    finally:
        server.stop()


def test_admission_control_reject_sheds_overflow():
    server = _server(_cfg(), (128,), max_batch=2, max_queue_depth=2,
                     shed_policy="reject", seed=0)
    verts, faces = _geom()
    results = server.serve([(verts, faces, 128)] * 4)
    assert len(results) == 4
    errs = [r for r in results if r.error is not None]
    ok = [r for r in results if r.error is None]
    assert len(errs) == 2 and len(ok) == 2
    assert all("queue full" in r.error for r in errs)
    assert server.stats.rejected_overload == 2
    assert server.stats._counters["rejected_overload"].value == 2


def test_admission_control_block_backpressures():
    server = _server(_cfg(), (128,), max_batch=1, max_queue_depth=1,
                     shed_policy="block", seed=0)
    server.warmup()
    server.start(deadline_s=0.001)
    verts, faces = _geom()
    try:
        rids = [server.submit(verts, faces, 128) for _ in range(3)]
        out = [server.result(r, timeout=60.0) for r in rids]
    finally:
        server.stop()
    assert all(r.error is None for r in out)
    assert server.stats.rejected_overload == 0


def test_invalid_shed_policy_rejected():
    with pytest.raises(ValueError, match="shed_policy"):
        _server(_cfg(), (128,), shed_policy="drop-everything")


# ---------------------------------------------------------------------------
# worker supervision
# ---------------------------------------------------------------------------

def test_worker_crash_fails_pending_then_restarts():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    server.warmup()
    verts, faces = _geom()
    doomed = server.submit(verts, faces, 128)
    FAULTS.arm("serve.worker", nth=1, times=1)
    server.start(deadline_s=0.005)
    try:
        res = server.result(doomed, timeout=30.0)
        assert res.error is not None and "worker crashed" in res.error
        good = server.submit(verts, faces, 128)
        ok = server.result(good, timeout=60.0)
        assert ok.error is None and np.isfinite(ok.fields).all()
    finally:
        server.stop()
    assert server.stats.worker_crashes == 1
    assert server.stats.worker_restarts == 1
    rep = server.stats.report()
    assert rep["worker_crashes"] == 1 and rep["worker_restarts"] == 1
    assert server.stats._counters["worker_crashes"].value == 1


def test_worker_dead_past_restart_budget_never_hangs_submits():
    server = _server(_cfg(), (128,), max_batch=1, worker_max_restarts=0,
                     seed=0)
    FAULTS.arm("serve.worker", nth=1, times=-1)
    server.start(deadline_s=0.005)
    try:
        deadline = time.perf_counter() + 10.0
        while (not server.health()["worker_dead"]
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        assert server.health()["worker_dead"]
        verts, faces = _geom()
        rid = server.submit(verts, faces, 128)
        res = server.result(rid, timeout=5.0)
        assert res.error is not None and "dead" in res.error
    finally:
        server.stop()
    assert server.stats.worker_crashes == 1
    assert server.stats.worker_restarts == 0


def test_graceful_stop_serves_pending_waiter():
    server = _server(_cfg(), (128,), max_batch=4, seed=0)
    server.warmup()
    server.start(deadline_s=30.0)
    verts, faces = _geom()
    rid = server.submit(verts, faces, 128)
    got = {}

    def wait():
        got["res"] = server.result(rid, timeout=60.0)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.05)
    server.stop()
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert got["res"].error is None and np.isfinite(got["res"].fields).all()


def test_health_snapshot():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    h = server.health()
    assert h["worker_alive"] is False and h["queue_depth"] == 0
    server.start(deadline_s=0.005)
    try:
        assert server.health()["worker_alive"] is True
        assert float(server.stats.g_worker_alive.value) == 1.0
    finally:
        server.stop()
    h = server.health()
    assert h["worker_alive"] is False and not h["worker_dead"]
    assert float(server.stats.g_worker_alive.value) == 0.0
    for key in ("worker_crashes", "quarantined_buckets", "nonfinite_results",
                "timed_out_requests", "rejected_overload"):
        assert h[key] == 0


# ---------------------------------------------------------------------------
# bucket failure -> quarantine + fallback
# ---------------------------------------------------------------------------

def test_call_failure_falls_back_to_larger_bucket():
    verts, faces = _geom(3)
    want_server = _server(_cfg(), (256,), max_batch=2, seed=7)
    [want] = want_server.serve([(verts, faces, 100)])
    server = _server(_cfg(), (128, 256), max_batch=2, seed=7)
    FAULTS.arm("serve.compile", nth=1, times=1)       # 128's call dies
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        [got] = server.serve([(verts, faces, 100)])
    assert got.error is None and got.bucket == 256
    assert server.stats.quarantined_buckets == 1
    assert server.stats.bucket_fallbacks == 1
    assert sorted(server._quarantined) == [128]
    np.testing.assert_array_equal(got.fields, want.fields)
    [again] = server.serve([(verts, faces, 100)])
    assert again.bucket == 256 and again.error is None
    assert server.stats.bucket_fallbacks == 1


@pytest.mark.parametrize("site", ["bucket.build", "bucket.calibrate"])
def test_build_failure_quarantines_and_falls_back(site):
    """An auto bucket that fails to build (or calibrate) on first use is
    quarantined; its batch is served by the next larger size, and refits
    never target it again."""
    verts, faces = _geom(1)
    server = _server(_cfg(bucket_granularity=64), "auto", max_batch=2,
                     seed=0)
    small = server.submit(verts, faces, 64)           # grows 64, then 256
    big = server.submit(verts, faces, 256)
    FAULTS.arm(site, nth=1, times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = {r.request_id: r for r in server.flush()}
    assert res[small].error is None and res[small].bucket == 256
    assert res[big].error is None and res[big].bucket == 256
    rep = server.stats.report()
    assert rep["quarantined_buckets"] == 1 and rep["bucket_fallbacks"] == 1
    assert sorted(server._quarantined) == [64]
    assert 64 not in server.target_ladder()


def test_no_fallback_available_surfaces_error_then_quarantined_route():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    verts, faces = _geom()
    FAULTS.arm("serve.compile", nth=1, times=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FaultError):
            server.serve([(verts, faces, 100)])
        with pytest.raises(RuntimeError, match="quarantined"):
            server.submit(verts, faces, 100)


def test_async_dispatch_failure_still_harvests_batch_in_flight():
    """When dispatching batch j + 1 raises under the async flush, batch j,
    already on the card, is harvested (and recorded) before the error
    propagates."""
    server = _server(_cfg(), (64, 128), max_batch=1, seed=0)
    verts, faces = _geom()
    FAULTS.arm("serve.dispatch", nth=2, times=-1)
    server.submit(verts, faces, 64)
    server.submit(verts, faces, 128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FaultError):
            server.flush(async_mode=True)
    assert server.stats.report()["requests"] == 1
    assert server.stats.batch_sizes == [1]


# ---------------------------------------------------------------------------
# nonfinite harvest guard
# ---------------------------------------------------------------------------

def test_nan_harvest_contained_to_its_batch():
    verts, faces = _geom(1)
    reqs = [(verts, faces, 128)] * 3                  # batches of 2 + 1
    clean = _server(_cfg(), (128,), max_batch=2, seed=7)
    want = {r.request_id: r for r in clean.serve(reqs)}
    server = _server(_cfg(), (128,), max_batch=2, seed=7)
    FAULTS.arm("serve.harvest", mode="corrupt", nth=1, times=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = {r.request_id: r for r in server.serve(reqs)}
    assert len(got) == 3
    for rid in (0, 1):
        assert got[rid].error is not None
        assert "nonfinite output" in got[rid].error
        assert np.isnan(got[rid].fields).all()
    assert got[2].error is None
    np.testing.assert_array_equal(got[2].fields, want[2].fields)
    assert server.stats.nonfinite_results == 2
    assert server.stats.report()["nonfinite_results"] == 2


def test_partial_corruption_contained_to_its_request():
    """A NaN in one row of a 2-request batch errors that request only; its
    neighbour is served unchanged."""
    verts, faces = _geom(1)
    reqs = [(verts, faces, 128)] * 2
    clean = _server(_cfg(), (128,), max_batch=2, seed=7)
    want = {r.request_id: r for r in clean.serve(reqs)}
    shape, frac = (2, 128, 4), 1.0 / (128 * 4)
    seed = next(s for s in range(1000)
                if _row_hits(s, shape, frac) == [True, False])
    server = _server(_cfg(), (128,), max_batch=2, seed=7)
    FAULTS.arm("serve.harvest", mode="corrupt", frac=frac, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = {r.request_id: r for r in server.serve(reqs)}
    assert got[0].error is not None and "nonfinite" in got[0].error
    assert got[1].error is None
    np.testing.assert_array_equal(got[1].fields, want[1].fields)
    assert server.stats.nonfinite_results == 1


def _row_hits(seed, shape, frac):
    """Which rows the corrupt site's mask (seeded by (seed, hit 1)) hits."""
    mask = np.random.default_rng((seed, 1)).random(shape) < frac
    return [bool(m.any()) for m in mask]


def test_nan_guard_disabled_passes_garbage_through():
    server = _server(_cfg(nonfinite_guard=False), (128,), max_batch=1,
                     seed=0)
    verts, faces = _geom()
    FAULTS.arm("serve.harvest", mode="corrupt", nth=1, times=1)
    [res] = server.serve([(verts, faces, 128)])
    assert res.error is None and np.isnan(res.fields).all()
    assert server.stats.nonfinite_results == 0


def test_background_worker_survives_nan_output():
    server = _server(_cfg(), (128,), max_batch=1, seed=0)
    server.warmup()
    server.start(deadline_s=0.005)
    verts, faces = _geom()
    FAULTS.arm("serve.harvest", mode="corrupt", nth=1, times=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bad = server.submit(verts, faces, 128)
            res = server.result(bad, timeout=60.0)
            assert res.error is not None and "nonfinite" in res.error
            good = server.submit(verts, faces, 128)
            ok = server.result(good, timeout=60.0)
    finally:
        server.stop()
    assert ok.error is None and np.isfinite(ok.fields).all()


def test_chaos_every_request_terminates_exactly_once():
    server = _server(_cfg(), (128,), max_batch=2, seed=0)
    server.warmup()
    verts, faces = _geom()
    FAULTS.arm("serve.harvest", mode="corrupt", nth=1, times=1)
    FAULTS.arm("serve.worker", nth=3, times=1)
    rids = [server.submit(verts, faces, 128) for _ in range(4)]
    server.start(deadline_s=0.005)
    out = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rids += [server.submit(verts, faces, 128) for _ in range(4)]
            for rid in rids:
                out[rid] = server.result(rid, timeout=60.0)
    finally:
        server.stop()
    assert sorted(out) == sorted(rids) == list(range(8))
    for rid, res in out.items():
        assert res.request_id == rid
        assert (res.error is not None) or np.isfinite(res.fields).all()
    assert [r for r in out.values() if r.error is None]


# ---------------------------------------------------------------------------
# ServerStats and telemetry
# ---------------------------------------------------------------------------

def test_server_stats_report_schema():
    stats = ServerStats()
    rep = stats.report()
    for key in ("requests", "p50_ms", "p95_ms", "p99_ms", "mean_batch",
                "throughput_rps", "padding_waste_frac", "overflow_requests",
                "rejected_requests", "oversize_requests", "bucket_hits",
                "bucket_misses", "bucket_evictions", "bucket_compiles",
                "cache_loads", "bucket_calibrations", "grown_buckets",
                "stages", "by_bucket", *ServerStats._RESILIENCE):
        assert key in rep, key
    assert rep["requests"] == 0 and rep["p50_ms"] == 0.0
    assert rep["mean_batch"] == 0.0 and rep["by_bucket"] == {}
    assert sorted(rep["stages"]) == sorted(SERVE_STAGES)
    assert stats.latencies_s == [] and stats.batch_sizes == []

    stats.record_request(128, 0.010, 0.004)
    stats.record_request(128, 0.020, 0.006)
    stats.record_batch(2)
    stats.record_stage("prepare", 0.001)
    with stats.lock:
        stats.t_serving = 0.1
    rep = stats.report()
    assert rep["requests"] == 2
    assert 0.0 < rep["p50_ms"] <= rep["p95_ms"] <= 20.0 + 1e-6
    assert rep["mean_batch"] == 2.0
    assert rep["stages"]["prepare"]["count"] == 1
    bb = rep["by_bucket"][128]
    assert bb["requests"] == 2
    assert bb["mean_ms"] == pytest.approx(15.0)
    assert bb["run_mean_ms"] == pytest.approx(5.0)
    assert 10.0 <= bb["p50_ms"] <= bb["p95_ms"] <= 20.0
    assert 4.0 <= bb["run_p50_ms"] <= 6.0
    assert stats.latencies_s == [0.010, 0.020] and stats.batch_sizes == [2]


def test_server_stats_memory_bounded():
    stats = ServerStats(recent_cap=16)
    for i in range(10_000):
        stats.record_request(64 * (1 + i % 3), i * 1e-6, i * 5e-7)
        stats.record_batch(1 + i % 4)
    assert len(stats.latencies_s) == 16 and len(stats.batch_sizes) == 16
    rep = stats.report()
    assert rep["requests"] == 10_000
    assert sorted(rep["by_bucket"]) == [64, 128, 192]
    assert sum(b["requests"] for b in rep["by_bucket"].values()) == 10_000
    assert rep["p95_ms"] >= rep["p50_ms"] > 0.0
    stats.reset()
    assert stats.report()["requests"] == 0
    assert stats.report()["by_bucket"] == {} and stats.latencies_s == []


def test_server_telemetry_disabled_by_default():
    server = _server(_cfg(), (128,), max_batch=2)
    assert not server.telemetry.enabled
    assert server.telemetry.tracer is NULL_TRACER
    assert server.stats.metrics is server.telemetry.metrics


def test_server_telemetry_end_to_end(tmp_path):
    """Background worker + concurrent submitters with telemetry on: spans
    cover the request lifecycle, stitch by trace_id across threads, stay
    well nested per thread, and the artifacts export."""
    cfg = _cfg(telemetry=True, trace_dir=str(tmp_path))
    server = _server(cfg, (128,), max_batch=2, seed=0)
    assert server.telemetry.enabled
    verts, faces = _geom()
    server.start(deadline_s=0.01)
    ids, lock = [], threading.Lock()

    def client(k):
        for _ in range(3):
            rid = server.submit(verts, faces, 100 + 7 * k)
            with lock:
                ids.append(rid)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    try:
        results = [server.result(rid, timeout=60) for rid in ids]
    finally:
        server.stop()
    assert all(r.error is None for r in results)

    recs = server.telemetry.tracer.records()
    names = {r.name for r in recs}
    assert {"submit", "bucket_route", "queue_wait", "prepare", "dispatch",
            "device_wait", "harvest", "request", "result",
            "flush"} <= names, names
    assert check_well_nested(recs) == []
    for rid in ids:
        stages = {r.name for r in recs if r.trace_id == f"req-{rid}"}
        assert {"submit", "queue_wait", "request"} <= stages, (rid, stages)
    t_names = {r.thread_name for r in recs}
    assert "gnn-serve-worker" in t_names and len(t_names) >= 2

    rep = server.stats.report()
    for stage in ("queue_wait", "prepare", "dispatch", "device_wait",
                  "harvest"):
        assert rep["stages"][stage]["count"] > 0, stage
    # the port compiles nothing per bucket
    assert rep["stages"]["compile"]["count"] == 0
    assert rep["stages"]["cache_load"]["count"] == 0

    paths = server.telemetry.export()
    assert os.path.exists(paths["trace_jsonl"])
    spans = [json.loads(line) for line in open(paths["trace_jsonl"])]
    assert len(spans) == len(recs)
    chrome = json.load(open(paths["trace_chrome"]))
    assert len(chrome["traceEvents"]) > len(recs)
    prom = open(paths["metrics_prom"]).read()
    assert "serve_request_latency_seconds_count" in prom
    assert "serve_worker_alive" in prom
