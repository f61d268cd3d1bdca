"""Points to fields through the port's pipeline (CPU) against
``repro.graphx.pipeline``, single and batched, with and without
normalizers. Tolerance 1e-4, as in tests/test_graphx.py. Serving over the
compacted edge set against the padded union, and the batched function's
one wait a batch."""
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
from repro_torch.models import meshgraphnet as mgn
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


def _torch_setup(levels):
    """The port alone at ``levels``: a spec calibrated on a cloud of the
    finest size, and random weights."""
    pts, nrm = _cloud(levels[-1], 3)
    cfg = GNNConfig().reduced().replace(levels=levels)
    ms = multiscale.MultiscaleSpec(levels, 6, tuple(
        hashgrid.calibrate_spec(pts[:m], 6, n_points=m) for m in levels))
    model = mgn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, ms, model, torch.from_numpy(pts), torch.from_numpy(nrm)


@pytest.mark.parametrize("levels", [(128, 256), LEVELS],
                         ids=["2levels", "3levels"])
@pytest.mark.parametrize("n_valid", [256, 200], ids=["full", "partial"])
def test_compacted_infer_matches_padded_forward(levels, n_valid):
    """Serving over the valid edges only gives the padded union's answer:
    the model over every slot with the edge mask, as it ran before the
    compaction."""
    cfg, ms, model, pts, nrm = _torch_setup(levels)
    s, r, em = multiscale.multiscale_edges(pts, n_valid, ms)
    assert 0 < int(em.sum()) < ms.n_edges
    cs, cr = pipeline.compact_edges(s, r, em, int(em.sum()))
    assert torch.equal(cs, s[em]) and torch.equal(cr, r[em])
    want = pipeline.make_graph_forward(cfg)(model, pts, nrm, s, r, em)
    got = pipeline.make_infer_fn(cfg, ms)(model, pts, nrm, n_valid)
    assert float((got - want).abs().max()) <= 1e-6


def test_batched_infer_compacts_every_row_before_any_forward(monkeypatch):
    """One wait a batch: every row's graph is compacted before the first
    row's forward is called, and ``on_edges`` gets each row's valid-edge
    count once."""
    cfg, ms, model, pts, nrm = _torch_setup(LEVELS)
    events, reported = [], []
    compact = pipeline.compact_edges

    def spy_compact(s, r, em, n_edges):
        events.append(("compact", int(em.sum()), n_edges))
        return compact(s, r, em, n_edges)
    monkeypatch.setattr(pipeline, "compact_edges", spy_compact)
    apply = model.apply

    def spy_apply(*args, **kw):
        events.append(("forward", kw.get("edge_mask")))
        return apply(*args, **kw)
    monkeypatch.setattr(model, "apply", spy_apply)
    nv = [256, 256, 180]
    out = pipeline.make_batched_infer_fn(cfg, ms, on_edges=reported.append)(
        model, torch.stack([pts] * 3), torch.stack([nrm] * 3),
        torch.tensor(nv))
    assert out.shape == (3, 256, 4)
    assert [e[0] for e in events] == ["compact"] * 3 + ["forward"] * 3
    # each row's count was read before its compaction, and no mask is left
    assert all(n == c for _, n, c in events[:3])
    assert all(m is None for _, m in events[3:])
    assert reported == [[n for _, n, _ in events[:3]]]
    assert reported[0][0] == reported[0][1] > reported[0][2]
