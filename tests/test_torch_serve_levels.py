"""``GNNServer(n_levels=..., check_requests=...)`` in the port against the
JAX server on the CPU: servers of 2 and 4 levels a bucket (the JAX
server's weights carried over) serve the JAX server's fields within 1e-4,
with one kNN launch of the plain version a level; a JAX artifact saved
with ``n_levels=2`` restores a 2-level server that serves the JAX fields;
``check_requests=False`` skips the overflow guard and nothing else."""
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
from repro_torch.kernels.knn import ref as knn_ref
from repro_torch.launch.serve_gnn import GNNServer
from repro_torch.models.convert import params_from_jax

LEVELS = (64, 128, 256)
BUCKET = 256
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _quiet():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    params = jmgn.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params


def _car(i):
    return geo.car_surface(geo.sample_params(i))


def _port(weights, **kw):
    jcfg, params = weights
    cfg = GNNConfig().reduced().replace(levels=LEVELS)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return GNNServer(cfg, (BUCKET,), params=model, seed=3, max_batch=2,
                     device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_two(weights):
    """The JAX server of 2 levels and its fields for cars 1 and 2."""
    jcfg, params = weights
    srv = JaxGNNServer(jcfg, (BUCKET,), params=params, seed=3, max_batch=2,
                       n_levels=2)
    return srv, srv.serve([(*_car(1), 200), (*_car(2), BUCKET)])


def _close(got, want):
    for g, w in zip(got, want):
        assert g.request_id == w.request_id and g.error is None
        assert np.array_equal(g.points, np.asarray(w.points))
        np.testing.assert_allclose(g.fields, np.asarray(w.fields), rtol=0,
                                   atol=ATOL)


def _counting_knn(monkeypatch):
    calls = []
    fn = knn_ref.topk_neighbors

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(knn_ref, "topk_neighbors", counted)
    return calls


def test_two_levels_serve_the_jax_fields(weights, jax_two, monkeypatch):
    _, want = jax_two
    srv = _port(weights, n_levels=2)
    assert srv._calib[BUCKET].level_sizes == (128, 256)
    calls = _counting_knn(monkeypatch)
    got = srv.serve([(*_car(1), 200), (*_car(2), BUCKET)])
    _close(got, want)
    assert len(calls) == 2 * 2          # a kNN a level, for each request


def test_four_levels_serve_the_jax_fields(weights, monkeypatch):
    jcfg, params = weights
    jsrv = JaxGNNServer(jcfg, (BUCKET,), params=params, seed=3, max_batch=2,
                        n_levels=4)
    want = jsrv.serve([(*_car(3), BUCKET)])
    srv = _port(weights, n_levels=4)
    assert srv._calib[BUCKET].level_sizes == (32, 64, 128, 256)
    calls = _counting_knn(monkeypatch)
    _close(srv.serve([(*_car(3), BUCKET)]), want)
    assert len(calls) == 4


def test_a_jax_artifact_of_two_levels_restores_two_levels(jax_two,
                                                          tmp_path):
    jsrv, want = jax_two
    path = str(tmp_path / "jax_deploy.msgpack")
    jsrv.save_artifact(path)
    srv = GNNServer.from_artifact(path, device="cpu")
    assert srv.n_levels == 2 and srv.check_requests
    assert srv._calib[BUCKET].level_sizes == (128, 256)
    _close(srv.serve([(*_car(1), 200), (*_car(2), BUCKET)]), want)
    assert srv.stats.report()["bucket_calibrations"] == 0


def test_check_requests_off_skips_the_guard_only(weights, monkeypatch):
    reqs = [(*_car(4), BUCKET), (*_car(5), 180)]
    on = _port(weights)
    want = on.serve(reqs)
    off = _port(weights, check_requests=False)
    checks = []
    guard = GNNServer._check_cloud

    def counted(self, *a, **k):
        checks.append(1)
        return guard(self, *a, **k)
    monkeypatch.setattr(GNNServer, "_check_cloud", counted)
    got = off.serve(reqs)
    assert checks == []
    for g, w in zip(got, want):
        assert np.array_equal(g.points, w.points)
        assert np.array_equal(g.fields, w.fields)
    on.serve(reqs)
    assert len(checks) == 2
