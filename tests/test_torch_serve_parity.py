"""The port's GNNServer against the JAX GNNServer on the same traffic, on the
CPU: the same request ids, bit-equal sampled points, fields within 1e-4,
the same ``target_ladder()`` after every submit, and equal counters (cache
hits, misses, evictions, calibrations, grown and oversize asks, rejections,
timeouts, shed submits, quarantines and fallbacks).

One difference is by design: the JAX server pads a partial batch to
``max_batch`` rows by replaying its last request (so that each bucket
compiles once), and counts those rows in ``padding_points``; the port runs
only the real requests. Each test holds ``padding_points`` to JAX's less
those replay rows, counted from the batches the port harvested.
"""
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.launch.serve_gnn import GNNServer as JaxGNNServer
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.launch.serve_gnn import GNNServer
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
ATOL = 1e-4
COUNTERS = ("bucket_hits", "bucket_misses", "bucket_evictions",
            "bucket_calibrations", "grown_buckets", "oversize_requests",
            "rejected_requests", "overflow_requests", "timed_out_requests",
            "rejected_overload", "quarantined_buckets", "bucket_fallbacks",
            "nonfinite_results", "requested_points")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _pair(buckets, cfg_kw=None, **kw):
    """A JAX server and a port server of the same weights and knobs; the
    port's records (bucket, rows, recorded) of every batch it harvests."""
    cfg_kw = cfg_kw or {}
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS, **cfg_kw)
    cfg = GNNConfig().reduced().replace(levels=LEVELS, **cfg_kw)
    params = jmgn.init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    jserver = JaxGNNServer(jcfg, buckets, params=params, seed=3, **kw)
    server = GNNServer(cfg, buckets, params=model, seed=3, device="cpu",
                       **kw)
    server.batches = []
    harvest = server._harvest

    def recording(fl):
        if fl.host is not None and fl.record:
            server.batches.append((fl.bucket.n_points, len(fl.ok_reqs)))
        return harvest(fl)

    server._harvest = recording
    return jserver, server


def _car(i):
    return geo.car_surface(geo.sample_params(i))


def _submit_both(jserver, server, reqs):
    """Submit each (verts, faces, n_points[, timeout_s]) to both servers:
    equal request ids and equal target ladders after every submit."""
    rids = []
    for req in reqs:
        verts, faces, n = req[:3]
        kw = {"timeout_s": req[3]} if len(req) > 3 else {}
        rid = jserver.submit(verts, faces, n, **kw)
        assert server.submit(verts, faces, n, **kw) == rid
        assert server.target_ladder() == jserver.target_ladder()
        rids.append(rid)
    return rids


def _same_results(got, want):
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        assert g.bucket == w.bucket and g.batch_size == w.batch_size
        assert (g.error is None) == (w.error is None), (g.error, w.error)
        np.testing.assert_array_equal(g.points, np.asarray(w.points))
        assert g.fields.shape == np.shape(w.fields)
        np.testing.assert_allclose(g.fields, np.asarray(w.fields),
                                   atol=ATOL, rtol=ATOL)


def _same_stats(jserver, server):
    jrep, rep = jserver.stats.report(), server.stats.report()
    for key in COUNTERS[:-1]:
        assert rep[key] == jrep[key], key
    assert server.stats.requested_points == jserver.stats.requested_points
    assert rep["requests"] == jrep["requests"]
    assert server.ladder() == jserver.ladder()
    assert server.target_ladder() == jserver.target_ladder()
    assert sorted(server._quarantined) == sorted(jserver._quarantined)
    # the JAX server's replay rows are its only extra padding
    replay = sum((server.max_batch - k) * n for n, k in server.batches)
    assert jserver.stats.padding_points - server.stats.padding_points \
        == replay
    assert rep["bucket_compiles"] == 0 and rep["cache_loads"] == 0


def test_parity_static_ladder():
    jserver, server = _pair((128, 256), max_batch=2)
    reqs = [(*_car(i), n) for i, n in
            enumerate((100, 256, 128, 64, 200, None, 90))]
    _submit_both(jserver, server, reqs)
    _same_results(server.flush(), jserver.flush())
    _same_stats(jserver, server)
    assert server.stats.batch_sizes == jserver.stats.batch_sizes
    assert any(k < 2 for _, k in server.batches)     # a partial batch ran


def test_parity_auto_growth_and_refit():
    jserver, server = _pair("auto", dict(bucket_granularity=8,
                                         bucket_refit_every=4,
                                         bucket_quantiles=(0.5,)),
                            max_batch=2)
    _submit_both(jserver, server, [(*_car(0), 256)])
    _same_results(server.flush(), jserver.flush())
    sizes = (40, 72, 40, 300, 40, 40, 100, 40, None)
    _submit_both(jserver, server,
                 [(*_car(i + 1), n) for i, n in enumerate(sizes)])
    _same_results(server.flush(), jserver.flush())
    _same_stats(jserver, server)
    assert server.stats.grown_buckets >= 2
    assert min(server.target_ladder()) < 256          # a refit target


def test_parity_lru_evict_then_rebuild():
    jserver, server = _pair("auto", dict(bucket_granularity=64,
                                         max_live_buckets=2), max_batch=1)
    for i, n in enumerate((64, 128, 192, 64)):
        reqs = [(*_car(i), n)]
        _submit_both(jserver, server, reqs)
        _same_results(server.flush(), jserver.flush())
        assert server.ladder() == jserver.ladder()
    _same_stats(jserver, server)
    rep = server.stats.report()
    assert rep["bucket_evictions"] == 2 and rep["bucket_misses"] == 4
    assert rep["bucket_calibrations"] == 3


def test_parity_reject_overflow():
    jserver, server = _pair((128, 512), max_batch=2, reject_overflow=True)
    dense = (np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 1e-3],
                       [100, 100, 100], [100.1, 100, 100],
                       [100, 100.1, 100.001]], np.float32),
             np.array([[0, 1, 2], [3, 4, 5]]))
    reqs = [(*_car(0), 1000), (*_car(1), 100), (*dense, 512),
            (*_car(2), 400), (*_car(3), 2000)]
    _submit_both(jserver, server, reqs)
    got, want = server.flush(), jserver.flush()
    _same_results(got, want)
    _same_stats(jserver, server)
    errors = [r.request_id for r in got if r.error is not None]
    assert errors == [0, 2, 4]
    assert server.stats.oversize_requests == 2
    assert server.stats.overflow_requests == 1


def test_parity_async_against_sync():
    """JAX's async flush, the port's sync flush and the port's async flush
    of the same traffic: the port's two flushes are bit-equal."""
    jserver, server = _pair((128, 256), max_batch=2)
    _, sync = _pair((128, 256), max_batch=2, async_flush=False)
    reqs = [(*_car(i), n) for i, n in enumerate((100, 256, 128, 64, 200))]
    _submit_both(jserver, server, reqs)
    for verts, faces, n in reqs:
        sync.submit(verts, faces, n)
    want = jserver.flush()
    got_async, got_sync = server.flush(), sync.flush()
    _same_results(got_async, want)
    _same_results(got_sync, want)
    for a, s in zip(got_async, got_sync):
        np.testing.assert_array_equal(a.fields, s.fields)
    _same_stats(jserver, server)
    _same_stats(jserver, sync)


def test_parity_deadlines_and_admission():
    jserver, server = _pair((128, 256), max_batch=2, max_queue_depth=3,
                            shed_policy="reject")
    reqs = [(*_car(0), 128, 0.01), (*_car(1), 128), (*_car(2), 256),
            (*_car(3), 128), (*_car(4), 100)]
    rids = _submit_both(jserver, server, reqs)
    time.sleep(0.05)
    got, want = server.flush(), jserver.flush()
    _same_results(got, want)
    assert got[0].request_id == rids[0] and "deadline" in got[0].error
    shed = [rids[3], rids[4]]
    _same_results([server._done.pop(r) for r in shed],
                  [jserver._done.pop(r) for r in shed])
    _same_stats(jserver, server)
    assert server.stats.timed_out_requests == 1
    assert server.stats.rejected_overload == 2
