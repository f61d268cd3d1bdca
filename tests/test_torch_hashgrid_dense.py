"""The rest of the port's hash grid (``repro_torch.graphx.hashgrid``) and
graph construction (``repro_torch.core.graph_build``) against the JAX
package's, on the CPU: the dense layout (``build_table``'s table equal to
JAX's, its neighbour sets equal to csr's and to JAX's), ``auto_spec`` in
both modes with overrides, ``calibrate_spec`` with other margins and either
layout, ``max_knn_cell_ratio``, and ``sample_volume``, ``radius_edges`` and
``build_graph``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_build as jgb
from repro.data import geometry as jgeo
from repro.graphx import hashgrid as jhg
from repro_torch.core import graph_build as pgb
from repro_torch.graphx import hashgrid as phg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "car":
        verts, faces = jgeo.car_surface(jgeo.sample_params(seed))
        return jgb.sample_surface(verts, faces, n, rng)[0]
    if kind == "uniform":
        return rng.random((n, 3)).astype(np.float32)
    if kind == "clustered":
        c = rng.random((max(n // 32, 1), 3)).astype(np.float32) * 10.0
        return (c[rng.integers(0, len(c), n)]
                + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    raise ValueError(kind)


def _port_spec(spec) -> phg.GridSpec:
    return phg.GridSpec(**dataclasses.asdict(spec))


CLOUDS = [("car", 600, 0), ("uniform", 300, 1), ("clustered", 500, 2)]
PAD = 31

_jit_table = jax.jit(jhg.build_table, static_argnames=("spec",))
_jit_knn = jax.jit(jhg.knn, static_argnames=("spec",))


@functools.lru_cache(None)
def jax_refs(kind: str, n: int, seed: int) -> dict:
    """JAX's dense grid of a cloud (calibrated on its n points, the buffer
    padded by PAD rows): the table of the padded buffer and the kNN of the
    cloud, jitted once each."""
    pts = _cloud(kind, n, seed)
    buf = np.zeros((n + PAD, 3), np.float32)
    buf[:n] = pts
    spec = jhg.calibrate_spec(pts, 6, layout="dense")
    pspec = dataclasses.replace(spec, n_points=n + PAD)
    table = tuple(map(np.asarray, _jit_table(jnp.asarray(buf), n,
                                             spec=pspec)))
    knn = tuple(map(np.asarray, _jit_knn(jnp.asarray(pts), n, spec=spec)))
    return dict(pts=pts, buf=buf, spec=spec, pspec=pspec, table=table,
                knn=knn)


@pytest.mark.parametrize("kind,n,seed", CLOUDS)
def test_build_table_matches_jax(kind, n, seed):
    """The padded buffer (n valid of a larger one) gives JAX's table, cell
    ids and valid mask, entry for entry."""
    ref = jax_refs(kind, n, seed)
    spec = ref["pspec"]
    jt, jc, jv = ref["table"]
    pt, pc, pv = phg.build_table(torch.from_numpy(ref["buf"]), n,
                                 _port_spec(spec))
    assert pt.dtype == torch.int32 and pt.shape == (spec.n_cells,
                                                    spec.neigh_cap)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(pv.numpy(), jv)


def test_build_table_drops_overflow_as_jax():
    """A capacity below the fullest neighbourhood: the same slots dropped."""
    pts = _cloud("clustered", 400, 5)
    spec = dataclasses.replace(
        jhg.calibrate_spec(pts, 6, layout="dense"), neigh_cap=24)
    assert jhg.overflow_count(pts, 400, spec) > 0
    jt = np.asarray(_jit_table(jnp.asarray(pts), 400, spec=spec)[0])
    pt = phg.build_table(torch.from_numpy(pts), 400, _port_spec(spec))[0]
    np.testing.assert_array_equal(pt.numpy(), jt)


@pytest.mark.parametrize("kind,n,seed", CLOUDS)
def test_dense_knn_matches_csr_and_jax(kind, n, seed):
    """On one grid the two layouts give the same neighbour sets, masks and
    sorted distances, and the dense layout gives JAX's neighbours."""
    ref = jax_refs(kind, n, seed)
    dense = ref["spec"]
    csr = dataclasses.replace(dense, layout="csr")
    t = torch.from_numpy(ref["pts"])
    di, dd, dm = phg.knn(t, n, _port_spec(dense))
    ci, cd, cm = phg.knn(t, n, _port_spec(csr))
    ji, jd, jm = ref["knn"]
    np.testing.assert_array_equal(dm.numpy(), cm.numpy())
    np.testing.assert_array_equal(dm.numpy(), jm)
    np.testing.assert_array_equal(np.sort(dd.numpy(), 1),
                                  np.sort(cd.numpy(), 1))
    np.testing.assert_allclose(dd.numpy(), jd, rtol=1e-6, atol=1e-7)
    for a, b, c, m in zip(di.numpy(), ci.numpy(), ji, dm.numpy()):
        assert set(a[m]) == set(b[m]) == set(c[m])


def test_dense_candidate_lists_match_jax():
    pts = _cloud("uniform", 257, 7)
    buf = np.zeros((288, 3), np.float32)
    buf[:257] = pts
    spec = jhg.calibrate_spec(pts, 5, n_points=288, layout="dense")
    want = list(map(np.asarray, jax.jit(
        jhg.candidate_lists, static_argnames=("spec",))(
            jnp.asarray(buf), 257, spec=spec)))
    got = phg.candidate_lists(torch.from_numpy(buf), 257, _port_spec(spec))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kw", [
    dict(), dict(mode="volume"), dict(resolution=7),
    dict(resolution=(5, 9, 3)),
    dict(neigh_cap=300), dict(mode="volume", resolution=4, neigh_cap=64),
    dict(layout="dense"), dict(mode="volume", layout="dense", k=4)])
@pytest.mark.parametrize("n", [100, 4096, 262_144])
def test_auto_spec_matches_jax(n, kw):
    kw = dict(kw)
    k = kw.pop("k", 6)
    got = phg.auto_spec(n, k, **kw)
    want = jhg.auto_spec(n, k, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_candidates == want.n_candidates


@pytest.mark.parametrize("kw", [
    dict(), dict(cell_safety=1.0), dict(occupancy_safety=2.5),
    dict(layout="dense"), dict(layout="dense", cell_budget=0.5),
    dict(cell_safety=1.7, occupancy_safety=1.1, cell_budget=2.0,
         layout="dense")])
@pytest.mark.parametrize("kind,n,seed", [("car", 2048, 4),
                                         ("clustered", 700, 6)])
def test_calibrate_spec_matches_jax(kind, n, seed, kw):
    pts = _cloud(kind, n, seed)
    got = phg.calibrate_spec(pts, 6, n_points=n + 64, **kw)
    want = jhg.calibrate_spec(pts, 6, n_points=n + 64, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kind,n,seed", CLOUDS)
def test_max_knn_cell_ratio_matches_jax(kind, n, seed):
    pts = _cloud(kind, n, seed)
    for layout in ("csr", "dense"):
        spec = jhg.calibrate_spec(pts, 6, layout=layout)
        assert phg.max_knn_cell_ratio(pts, n - 5, _port_spec(spec)) == \
            jhg.max_knn_cell_ratio(pts, n - 5, spec)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_volume_matches_jax(seed):
    verts, _ = jgeo.car_surface(jgeo.sample_params(seed))
    got = pgb.sample_volume(verts, 1000, np.random.default_rng(seed))
    want = jgb.sample_volume(verts, 1000, np.random.default_rng(seed))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,max_degree", [(0.15, 64), (0.3, 5),
                                               (1e-4, 64)])
def test_radius_edges_match_jax(radius, max_degree):
    pts = _cloud("uniform", 400, 8)
    got = pgb.radius_edges(pts, radius, max_degree)
    want = jgb.radius_edges(pts, radius, max_degree)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_normals", [False, True])
def test_build_graph_matches_jax(with_normals):
    verts, faces = jgeo.car_surface(jgeo.sample_params(2))
    pts, normals = jgb.sample_surface(verts, faces, 500,
                                      np.random.default_rng(2))
    nrm = normals if with_normals else None
    got = pgb.build_graph(pts, 6, nrm)
    want = jgb.build_graph(pts, 6, nrm)
    for field in ("positions", "senders", "receivers", "edge_feats",
                  "normals"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.n_edges == want.n_edges and got.n_nodes == want.n_nodes
