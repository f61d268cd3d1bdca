"""The port's graph construction (hash-grid kNN, symmetric edges,
multi-scale union, features) on the CPU against ``repro.graphx``.

Edge arrays must be equal, which makes the edge sets equal; features agree
to 1e-6 (sin/cos and the norm come from different math libraries)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphx import features as jfx
from repro.graphx import hashgrid as jhg
from repro.graphx import multiscale as jms
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.graphx import features as fx
from repro_torch.graphx import hashgrid
from repro_torch.graphx import multiscale


def _make_cloud(family: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """The cloud families of tests/test_hashgrid_csr.py."""
    if family == "uniform":
        return rng.random((n, 3)).astype(np.float32)
    if family == "clustered":
        k = max(n // 32, 1)
        centers = rng.random((k, 3)).astype(np.float32) * 10.0
        return (centers[rng.integers(0, k, n)]
                + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    if family == "coplanar":
        pts = rng.random((n, 3)).astype(np.float32)
        pts[:, 2] = 0.25
        return pts
    if family == "duplicates":
        base = rng.random((max(n // 3, 1), 3)).astype(np.float32)
        return base[rng.integers(0, len(base), n)]
    raise ValueError(family)


def _car_cloud(n, seed=0):
    verts, faces = geo.car_surface(geo.sample_params(seed))
    return sample_surface(verts, faces, n, np.random.default_rng(seed))


def _jspec(spec: hashgrid.GridSpec) -> jhg.GridSpec:
    return jhg.GridSpec(n_points=spec.n_points, k=spec.k,
                        resolution=spec.resolution, neigh_cap=spec.neigh_cap)


FAMILIES = ["uniform", "clustered", "coplanar", "duplicates"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n_valid", [None, 170])
def test_knn_and_symmetric_edges_match_jax(family, n_valid):
    n, k = 200, 6
    rng = np.random.default_rng(FAMILIES.index(family))
    pts = _make_cloud(family, n, rng)
    nv = n if n_valid is None else n_valid
    spec = hashgrid.calibrate_spec(pts[:nv], k, n_points=n)
    jspec = jhg.calibrate_spec(pts[:nv], k, n_points=n)
    assert _jspec(spec) == jspec

    ji, jd, jm = map(np.asarray, jhg.knn(jnp.asarray(pts), nv, jspec))
    ti, td, tm = hashgrid.knn(torch.from_numpy(pts), nv, spec)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(td.numpy()[jm], jd[jm], atol=1e-6, rtol=0)

    js, jr, je = map(np.asarray, jhg.symmetric_edges(jnp.asarray(ji),
                                                     jnp.asarray(jm)))
    ts, tr, te = hashgrid.symmetric_edges(ti, tm)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(te.numpy(), je)


def test_candidate_lists_match_jax():
    """Same candidate slot order as the JAX CSR (it fixes the tie-breaks)."""
    pts, _ = _car_cloud(300, 1)
    spec = hashgrid.calibrate_spec(pts, 6)
    jc, jv, jq = map(np.asarray, jhg.csr_candidate_lists(
        jnp.asarray(pts), 300, _jspec(spec)))
    tc, tv, tq = hashgrid.csr_candidate_lists(torch.from_numpy(pts), 300,
                                              spec)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(tc.numpy()[jv], jc[jv])


def test_calibration_and_overflow_match_jax():
    pts, _ = _car_cloud(512, 2)
    spec = hashgrid.calibrate_spec(pts, 6)
    assert _jspec(spec) == jhg.calibrate_spec(pts, 6)
    np.testing.assert_array_equal(
        hashgrid.neighborhood_counts(pts, spec.resolution),
        jhg.neighborhood_counts(pts, spec.resolution))
    tight = hashgrid.GridSpec(n_points=512, k=6, resolution=spec.resolution,
                              neigh_cap=8)
    assert hashgrid.overflow_count(pts, 512, tight) == \
        jhg.overflow_count(pts, 512, _jspec(tight)) > 0
    assert hashgrid.auto_spec(4096, 6) == \
        hashgrid.GridSpec(**vars(jhg.auto_spec(4096, 6)))


@pytest.mark.parametrize("n_valid", [512, 400])
def test_multiscale_edges_match_jax(n_valid):
    levels, k = (128, 256, 512), 6
    pts, _ = _car_cloud(512, 3)
    grids = tuple(hashgrid.calibrate_spec(pts[:m], k, n_points=m)
                  for m in levels)
    ms = multiscale.MultiscaleSpec(levels, k, grids)
    jms_spec = jms.MultiscaleSpec(levels, k, tuple(map(_jspec, grids)))
    edges = jax.jit(functools.partial(jms.multiscale_edges, ms=jms_spec))
    js, jr, je = map(np.asarray, edges(jnp.asarray(pts), n_valid))
    ts, tr, te = multiscale.multiscale_edges(torch.from_numpy(pts), n_valid,
                                             ms)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(te.numpy(), je)
    assert te.numpy().sum() > 0
    np.testing.assert_array_equal(ms.level_of_edge, jms_spec.level_of_edge)


def test_auto_multiscale_spec_matches_jax():
    ms = multiscale.auto_multiscale_spec((256, 512, 1024), 6)
    jspec = jms.auto_multiscale_spec((256, 512, 1024), 6)
    assert ms.n_edges == jspec.n_edges
    assert [_jspec(g) for g in ms.grids] == list(jspec.grids)
    with pytest.raises(ValueError):
        multiscale.auto_multiscale_spec((512, 256), 6)


def test_features_match_jax():
    pts, nrm = _car_cloud(256, 4)
    freqs = (2.0, 4.0, 8.0)
    want = np.asarray(jfx.node_input_features(jnp.asarray(pts),
                                              jnp.asarray(nrm), freqs))
    got = fx.node_input_features(torch.from_numpy(pts),
                                 torch.from_numpy(nrm), freqs)
    assert got.shape == (256, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert fx.fourier_features(torch.from_numpy(pts), ()).shape == (256, 0)

    rng = np.random.default_rng(5)
    s = rng.integers(0, 256, 700).astype(np.int32)
    r = rng.integers(0, 256, 700).astype(np.int32)
    m = rng.random(700) > 0.3
    want = np.asarray(jfx.relative_edge_features(
        jnp.asarray(pts), jnp.asarray(s), jnp.asarray(r), jnp.asarray(m)))
    got = fx.relative_edge_features(torch.from_numpy(pts),
                                    torch.from_numpy(s), torch.from_numpy(r),
                                    torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
