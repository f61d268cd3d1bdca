"""The port's twins of the JAX package's examples
(``repro_torch.examples``), ``core.multiscale.build_multiscale_graph`` and
``configs.list_configs``, on the CPU against the JAX package: each twin's
``main`` at small sizes; ``partition_equivalence`` with the JAX example's
weights carried over gives the JAX example's full-graph loss within 1e-5
and partition differences of at most 1e-5; ``serve_llm`` serves JAX's
tokens for reduced gemma2-9b."""
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.core import multiscale as jms
from repro.data import geometry as jgeo
from repro.launch.serve import serve as jax_serve
from repro.models import meshgraphnet as jmgn
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.core import multiscale as ms
from repro_torch.examples import (partition_equivalence, quickstart,
                                  realtime_inference, serve_llm)
from repro_torch.models.convert import params_from_jax, transformer_from_jax

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.set_num_threads(n)


def _edge_set(g, level):
    keep = g.level_of_edge == level
    return set(zip(g.senders[keep].tolist(), g.receivers[keep].tolist()))


@pytest.mark.parametrize("levels,k", [((100, 200, 400), 4),
                                      ((64, 256), 6)])
def test_build_multiscale_graph_matches_jax(levels, k):
    verts, faces = jgeo.car_surface(jgeo.sample_params(0), nu=32, nv=16)
    got = ms.build_multiscale_graph(verts, faces, levels, k,
                                    np.random.default_rng(4))
    want = jms.build_multiscale_graph(verts, faces, levels, k,
                                      np.random.default_rng(4))
    assert np.array_equal(got.positions, want.positions)
    assert np.array_equal(got.normals, want.normals)
    for level in range(len(levels)):
        assert _edge_set(got, level) == _edge_set(want, level)
    np.testing.assert_array_equal(got.edge_feats, want.edge_feats)
    with pytest.raises(ValueError, match="increasing"):
        ms.nested_point_clouds(verts, faces, levels[::-1],
                               np.random.default_rng(0))


def test_list_configs_names_jaxs():
    got, want = configs.list_configs(), jax_list_configs()
    assert list(got) == list(want)
    for name, cfg in got.items():
        assert cfg.name == want[name].name


@pytest.mark.parametrize("twin", [quickstart, realtime_inference,
                                  partition_equivalence, serve_llm])
def test_twins_run_on_the_card_by_default(twin):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([])


def test_quickstart_trains_and_reports(tmp_path, capsys):
    path = tmp_path / "quickstart.msgpack"
    out = quickstart.main(["--device", "cpu", "--steps", "3", "--samples",
                           "3", "--ckpt", str(path)])
    losses = out["losses"]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert set(out["metrics"]) == {"pressure", "tau_x", "tau_y", "tau_z",
                                   "force_r2"}
    assert path.stat().st_size > 0
    text = capsys.readouterr().out
    assert "points/level" in text and '"rel_l2"' in text


def test_realtime_inference_single_and_sharded(capsys):
    one = realtime_inference.main(["--device", "cpu", "--requests", "2"])
    two = realtime_inference.main(["--device", "cpu", "--requests", "2",
                                   "--shard-devices", "2"])
    for a, b in zip(one["results"], two["results"]):
        assert a.error is None and b.error is None
        assert a.fields.shape == (realtime_inference.N_POINTS, 4)
        assert np.array_equal(a.points, b.points)
        np.testing.assert_allclose(b.fields, a.fields, rtol=0, atol=1e-4)
    assert one["background"].error is None
    assert np.isfinite(one["background"].fields).all()
    text = capsys.readouterr().out
    assert "sharded x2" in text and "steady state" in text


def test_partition_equivalence_matches_the_jax_example():
    """The JAX example's computation with its weights (``PRNGKey(0)``):
    the port's full-graph loss within 1e-5 of it, and P = 2, 4, 8 within
    1e-5 of the full graph in loss and every gradient."""
    cfg = partition_equivalence.CFG
    jcfg = JaxGNNConfig(node_in=6, edge_in=4, node_out=4, hidden=64,
                        n_mp_layers=4, halo=4)
    params = jmgn.init(jax.random.PRNGKey(0), jcfg)
    pos, senders, receivers, nf, ef, tg = partition_equivalence.example_graph()
    full = {"node_feats": nf, "edge_feats": ef, "senders": senders,
            "receivers": receivers, "targets": tg,
            "loss_mask": np.ones(len(nf), np.float32)}
    want = float(jmgn.loss_fn(params, jcfg, full, denom=float(len(nf) * 4)))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    out = partition_equivalence.main(["--device", "cpu"], params=model)
    assert abs(out["full_loss"] - want) <= TOL
    assert sorted(out["parts"]) == [2, 4, 8]
    for p, row in out["parts"].items():
        assert row["loss_diff"] <= TOL and row["max_grad_diff"] <= TOL, p
        assert row["max_nodes"] < len(nf)
    # the seed's weights: another loss, the same equivalence
    seeded = partition_equivalence.main(["--device", "cpu", "--seed", "3"])
    assert seeded["full_loss"] != out["full_loss"]
    assert max(r["max_grad_diff"] for r in seeded["parts"].values()) <= TOL


def test_serve_llm_serves_jax_tokens():
    jcfg = jax_get_config("gemma2-9b").reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = transformer_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        configs.get_config("gemma2-9b").reduced(), device="cpu")
    want = jax_serve("gemma2-9b", True, 4, 16, 12)
    out = serve_llm.main(["--device", "cpu"], params={"gemma2-9b": model})
    np.testing.assert_array_equal(out["gemma2-9b"]["generated"],
                                  want["generated"])
    assert out["xlstm-350m"]["generated"].shape == (4, 12)
