"""The port's edge functions of the rollout slice (``graphx.pipeline``
``make_edges_fn``, ``device_multiscale_edges``) and the mesh-free training
graph source (``build_sample(source='graphx')``, ``train_gnn(graph_source=
'graphx')``) on the CPU, against ``repro`` and the port's host cKDTree build.

Edge arrays must be equal to JAX's, slot for slot after compaction; the
edge set (with level tags) equal to the host build's; features and targets
equal. Training losses to 1e-5 relative, as ``tests/test_torch_train.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.data import pipeline as jpipe
from repro.graphx import pipeline as jgp
from repro.graphx.multiscale import auto_multiscale_spec as jauto
from repro.launch import train as jtrain
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.core.multiscale import build_multiscale_from_points
from repro_torch.data import geometry as geo
from repro_torch.data import pipeline as pipe
from repro_torch.graphx import pipeline as gp
from repro_torch.graphx.multiscale import auto_multiscale_spec
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_from_jax

# train_gnn losses against JAX: f32 on both sides, matmuls and reductions
# summed in other orders (the value of tests/test_torch_train.py).
LOSS_RTOL = 1e-5
SIZE = dict(levels=(64, 128, 256), hidden=32, n_mp_layers=2, halo=2,
            n_partitions=4)


def _cloud(n, seed):
    verts, faces = geo.car_surface(geo.sample_params(seed))
    return sample_surface(verts, faces, n, np.random.default_rng(seed))


def _edge_set(s, r, lvl):
    return {(a, b): c for a, b, c in zip(s.tolist(), r.tolist(),
                                         lvl.tolist())}


@pytest.mark.parametrize("levels,seed", [((64, 128, 256), 0),
                                         ((128, 256, 512), 3)])
def test_device_multiscale_edges_match_jax_and_host(levels, seed):
    pts, _ = _cloud(levels[-1], seed)
    got = gp.device_multiscale_edges(pts, levels, 6, device="cpu")
    want = jgp.device_multiscale_edges(pts, levels, 6)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.asarray(w).dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    host = build_multiscale_from_points(pts, levels, 6)
    assert _edge_set(*got) == _edge_set(host.senders, host.receivers,
                                        host.level_of_edge)
    with pytest.raises(ValueError, match="finest level"):
        gp.device_multiscale_edges(pts[:-1], levels, 6, device="cpu")


def test_make_edges_fn_is_multiscale_edges_of_jax():
    """``make_edges_fn`` is the fixed-shape union of ``multiscale_edges``,
    with a partial ``n_valid``: the JAX one's arrays, slot for slot."""
    pts, _ = _cloud(256, 1)
    ms = auto_multiscale_spec((64, 128, 256), 6)
    got = gp.make_edges_fn(ms)(torch.from_numpy(pts.astype(np.float64)), 200)
    want = jgp.make_edges_fn(jauto((64, 128, 256), 6))(pts, 200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_sample_graphx_matches_jax_and_host():
    """The mesh-free training-graph build gives JAX's graph, and the same
    edge set, level tags, features and targets as the host build."""
    cfg = GNNConfig().reduced().replace(levels=(64, 128, 256))
    jcfg = JaxGNNConfig().reduced().replace(levels=(64, 128, 256))
    sx = pipe.build_sample(cfg, 0, source="graphx", device="cpu")
    jx = jpipe.build_sample(jcfg, 0, source="graphx")
    for name in ("senders", "receivers", "level_of_edge", "positions",
                 "normals", "edge_feats"):
        np.testing.assert_array_equal(getattr(sx.graph, name),
                                      getattr(jx.graph, name), err_msg=name)
    np.testing.assert_array_equal(sx.node_feats, jx.node_feats)
    np.testing.assert_array_equal(sx.targets, jx.targets)
    sh = pipe.build_sample(cfg, 0, source="host")
    np.testing.assert_array_equal(sh.node_feats, sx.node_feats)
    np.testing.assert_array_equal(sh.targets, sx.targets)
    assert _edge_set(sx.graph.senders, sx.graph.receivers,
                     sx.graph.level_of_edge) == \
        _edge_set(sh.graph.senders, sh.graph.receivers,
                  sh.graph.level_of_edge)
    with pytest.raises(ValueError, match="graph_source"):
        pipe.build_sample(cfg, 0, source="bogus")


def test_train_gnn_graphx_source_matches_jax(monkeypatch):
    """Two steps of ``train_gnn(graph_source='graphx')`` from the JAX init,
    against the JAX trainer on the same source."""
    jcfg = JaxGNNConfig().reduced().replace(**SIZE)
    cfg = GNNConfig().reduced().replace(**SIZE)
    params = jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(
        ptrain.meshgraphnet, "init",
        lambda gen, c, device=None: params_from_jax(params, c, device))
    _, want, _ = jtrain.train_gnn(jcfg, steps=2, n_samples=3,
                                  log_every=100, shard_devices=1,
                                  graph_source="graphx")
    _, got, (train, _, _, _) = ptrain.train_gnn(
        cfg, steps=2, n_samples=3, log_every=100, graph_source="graphx",
        device="cpu")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    host = pipe.build_sample(cfg, train[0].sample_id, source="host")
    assert train[0].graph.n_edges == host.graph.n_edges


def test_train_main_passes_graph_source(monkeypatch):
    seen = {}

    def fake(cfg, *a, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(ptrain, "train_gnn", fake)
    with pytest.raises(SystemExit):
        ptrain.main(["--arch", "xmgn-drivaer", "--reduced", "--device",
                     "cpu", "--graph-source", "graphx"])
    assert seen["graph_source"] == "graphx"
    assert seen["device"] == "cpu"
