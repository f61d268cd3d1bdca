"""The port's GNNServer (CPU) against the JAX GNNServer: same seed, same
request ids, converted params. Sampled points must be bit-equal and fields
agree to 1e-4."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.launch.serve_gnn import GNNServer as JaxGNNServer
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.launch import serve_gnn
from repro_torch.launch.serve_gnn import GNNServer, _level_sizes
from repro_torch.models import meshgraphnet
from repro_torch.models.convert import params_from_jax

LEVELS = (64, 128, 256)


def _requests():
    reqs = []
    for i, n_req in [(0, 100), (1, 128), (2, 200), (3, None)]:
        verts, faces = geo.car_surface(geo.sample_params(i))
        reqs.append((verts, faces, n_req))
    return reqs


def test_serve_matches_jax_server():
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    cfg = GNNConfig().reduced().replace(levels=LEVELS)
    params = jmgn.init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    jserver = JaxGNNServer(jcfg, (128, 256), params=params, max_batch=2,
                           seed=5)
    server = GNNServer(cfg, (128, 256), params=model, max_batch=2, seed=5,
                       device="cpu")
    want = {r.request_id: r for r in jserver.serve(_requests())}
    got = server.serve(_requests())
    assert [r.request_id for r in got] == [0, 1, 2, 3]
    for r in got:
        w = want[r.request_id]
        assert r.bucket == w.bucket
        np.testing.assert_array_equal(r.points, w.points)
        assert r.fields.shape == (r.bucket, 4)
        np.testing.assert_allclose(r.fields, w.fields, atol=1e-4, rtol=1e-4)
    rep = server.stats.report()
    assert rep["requests"] == 4 and rep["mean_batch"] == 2.0
    assert rep["p95_ms"] >= rep["p50_ms"] >= 0.0
    # per bucket: submit->result includes the wait behind earlier batches,
    # the batch's own run does not
    assert sorted(rep["by_bucket"]) == [128, 256]
    for bb in rep["by_bucket"].values():
        assert bb["requests"] == 2
        assert bb["p50_ms"] >= bb["run_p50_ms"] > 0.0
    assert rep["by_bucket"][256]["p50_ms"] > \
        rep["by_bucket"][128]["run_p50_ms"]


def test_routing_and_levels():
    assert _level_sizes(1024, 3) == (256, 512, 1024)
    server = GNNServer(GNNConfig().reduced().replace(levels=LEVELS),
                       (128, 256), max_batch=2, device="cpu")
    assert server.bucket_for(None) == 256
    assert server.bucket_for(128) == 128
    assert server.bucket_for(129) == 256
    verts, faces = geo.car_surface(geo.sample_params(0))
    with pytest.warns(UserWarning, match="exceeds the largest bucket"):
        server.submit(verts, faces, 10_000)
    assert server.stats.oversize_requests == 1 and server.pending() == 1


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without device= the port runs on the card; with no card it raises
    instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GNNConfig().reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer(cfg, (256,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshgraphnet.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--reduced", "--buckets", "256"])
    # the autoscaler, the background worker and checkpoint serving too: no
    # server exists on the card to start, and none falls back to the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer(cfg, "auto").start()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer(cfg.replace(bucket_policy="auto"), (256,),
                  async_flush=False).start(deadline_s=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer.from_checkpoint("unused.msgpack", cfg, "auto")
    for flags in (["--buckets", "auto"], ["--buckets", "256", "--sync"],
                  ["--buckets", "256", "--request-timeout", "1",
                   "--telemetry"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_gnn.main(["--reduced", *flags])


def test_main_runs_on_cpu(capsys):
    serve_gnn.main(["--reduced", "--buckets", "128", "--requests", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests on cpu" in out
