"""Serving from a training checkpoint on the CPU: a JAX-trained checkpoint
served by the port's ``GNNServer.from_checkpoint`` within 1e-4 of JAX's
server, a checkpoint that is not a training one refused, and the serving
CLI's ``--ckpt`` (split from ``test_torch_train_resume.py`` so that
``--dist loadfile`` spreads them). Size: ``tests/test_train_resume.py``'s
(``_torch_train_common.resume_cfg``)."""
import numpy as np
import pytest

from _torch_train_common import SERVE_TOL
from _torch_train_common import resume_cfg as _cfg
from _torch_train_common import resume_jcfg as _jcfg
from repro.ckpt import checkpoint as jckpt
from repro.data import geometry as jgeo
from repro.launch import serve_gnn as jserve
from repro.launch import train as jtrain
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import GNNConfig
from repro_torch.launch import serve_gnn
from repro_torch.launch import train as ptrain


def test_serve_jax_checkpoint_matches_jax_server(tmp_path):
    """A checkpoint trained by the JAX package, served by both packages'
    ``GNNServer.from_checkpoint``: bit-equal points, fields within 1e-4."""
    jcfg, cfg = _jcfg(), _cfg()
    p = str(tmp_path / "jax.msgpack")
    jtrain.train_gnn(jcfg, 2, 2, p, log_every=100, shard_devices=1)
    reqs = []
    for i, n in ((1, 100), (2, 128)):
        verts, faces = jgeo.car_surface(jgeo.sample_params(i))
        reqs.append((verts, faces, n))
    want = jserve.GNNServer.from_checkpoint(p, jcfg, (128,), max_batch=2,
                                            seed=3).serve(reqs)
    server = serve_gnn.GNNServer.from_checkpoint(p, cfg, (128,),
                                                 max_batch=2, seed=3,
                                                 device="cpu")
    got = server.serve(reqs)
    norm_in = server._norm_in
    tree = jckpt.restore(p)
    np.testing.assert_array_equal(norm_in[0], np.asarray(
        tree["norm_in"]["mean"]))
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_allclose(g.fields, w.fields, atol=SERVE_TOL,
                                   rtol=SERVE_TOL)
    # trained weights, not the random ones
    random = serve_gnn.GNNServer(cfg, (128,), max_batch=2, seed=3,
                                 device="cpu").serve(reqs)
    assert np.abs(random[0].fields - got[0].fields).max() > 1e-3


def test_serve_rejects_non_training_checkpoint(tmp_path):
    p = str(tmp_path / "x.msgpack")
    ckpt.save(p, {"step": 1})
    with pytest.raises(ValueError, match="not a GNN training checkpoint"):
        serve_gnn.load_gnn_checkpoint(p, _cfg(), device="cpu")


def test_serve_cli_loads_checkpoint(tmp_path, capsys):
    p = str(tmp_path / "cli.msgpack")
    ptrain.train_gnn(GNNConfig().reduced(), 1, 2, p, log_every=100,
                     device="cpu")
    serve_gnn.main(["--reduced", "--buckets", "256,512", "--device", "cpu",
                    "--requests", "2", "--ckpt", p])
    out = capsys.readouterr().out
    assert f"loaded checkpoint {p}" in out and "served 2 requests" in out
