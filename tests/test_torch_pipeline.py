"""Points to fields through the port's pipeline (CPU) against
``repro.graphx.pipeline``, single and batched, with and without
normalizers. Tolerance 1e-4, as in tests/test_graphx.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.graphx import hashgrid as jhg
from repro.graphx import multiscale as jms
from repro.graphx import pipeline as jpipe
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.graphx import hashgrid
from repro_torch.graphx import multiscale
from repro_torch.graphx import pipeline
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.models.convert import params_from_jax

TOL = 1e-4
LEVELS = (64, 128, 256)


def _cloud(n, seed):
    verts, faces = geo.car_surface(geo.sample_params(seed))
    return sample_surface(verts, faces, n, np.random.default_rng(seed))


def _setup(ref_pts):
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    cfg = GNNConfig().reduced().replace(levels=LEVELS)
    grids = tuple(hashgrid.calibrate_spec(ref_pts[:m], 6, n_points=m)
                  for m in LEVELS)
    ms = multiscale.MultiscaleSpec(LEVELS, 6, grids)
    jspec = jms.MultiscaleSpec(LEVELS, 6, tuple(
        jhg.GridSpec(g.n_points, g.k, g.resolution, g.neigh_cap)
        for g in grids))
    params = jmgn.init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, jspec, ms, params, model


@pytest.mark.parametrize("normed", [False, True])
def test_infer_matches_jax(normed):
    n = LEVELS[-1]
    pts, nrm = _cloud(n, 0)
    jcfg, cfg, jspec, ms, params, model = _setup(pts)
    kw = {}
    if normed:
        rng = np.random.default_rng(1)
        kw = dict(norm_in=(rng.normal(size=(1, 24)).astype(np.float32),
                           rng.uniform(0.5, 2, (1, 24)).astype(np.float32)),
                  norm_out=(np.full((1, 4), 2.0, np.float32),
                            np.full((1, 4), 3.0, np.float32)))
    want = np.asarray(jpipe.make_infer_fn(jcfg, jspec, **kw)(
        params, jnp.asarray(pts), jnp.asarray(nrm), n))
    seg0 = seg_ops.segment_sum_prepared.launches
    knn0 = knn_ops.topk_neighbors.launches
    got = pipeline.make_infer_fn(cfg, ms, **kw)(
        model, torch.from_numpy(pts), torch.from_numpy(nrm), n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the CPU path runs the plain versions: no kernel launch counted
    assert seg_ops.segment_sum_prepared.launches == seg0
    assert knn_ops.topk_neighbors.launches == knn0


def test_batched_infer_matches_jax():
    n = LEVELS[-1]
    clouds = [_cloud(n, s) for s in (10, 11, 12)]
    jcfg, cfg, jspec, ms, params, model = _setup(clouds[0][0])
    bp = np.stack([p for p, _ in clouds])
    bn = np.stack([m for _, m in clouds])
    nv = np.array([n, n, 200], np.int32)
    want = np.asarray(jpipe.make_batched_infer_fn(jcfg, jspec)(
        params, jnp.asarray(bp), jnp.asarray(bn), jnp.asarray(nv)))
    got = pipeline.make_batched_infer_fn(cfg, ms)(
        model, torch.from_numpy(bp), torch.from_numpy(bn),
        torch.from_numpy(nv))
    assert got.shape == (3, n, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
