"""Cold start in the port: deploy artifacts (``ckpt.artifact``,
``GNNServer.save_artifact`` / ``from_artifact``) and the kernels' build
directory as the compile cache (``ckpt.compile_cache``), on the CPU.

A restored server serves bit-equal fields and never calibrates, through a
restore and an evict->rebuild; the artifact file is the JAX package's
format both ways (the port serves a JAX-written artifact within 1e-4 of
that JAX server's fields, and JAX restores a port-written one). The build
directory and its counters are process-global: every test that moves them
puts them back.
"""
import hashlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ckpt import artifact as jartifact
from repro.ckpt import checkpoint as jckpt
from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.graphx.hashgrid import GridSpec as JGridSpec
from repro.graphx.multiscale import MultiscaleSpec as JMultiscaleSpec
from repro.launch.serve_gnn import GNNServer as JaxGNNServer
from repro_torch.ckpt import artifact
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import compile_cache
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.graphx import sharded
from repro_torch.graphx.hashgrid import GridSpec
from repro_torch.graphx.multiscale import MultiscaleSpec
from repro_torch.kernels import _build
from repro_torch.launch import serve_gnn, train
from repro_torch.launch.serve_gnn import GNNServer

SRC = Path(__file__).resolve().parents[1] / "src"
LEVELS = (64, 128, 256)
ATOL = 1e-4          # the port against the JAX server's fields
CHILD_TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_thread():
    """Bit-equal CPU sums across servers and processes, and tiny tensors
    that a pool of threads only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.set_num_threads(n)


@pytest.fixture
def build_dir(monkeypatch, tmp_path):
    """The kernels' build directory, the cache's setting, the loaded
    libraries and the counters, restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "counts", {"misses": 0, "hits": 0})
    return tmp_path


def _cfg(**kw):
    return GNNConfig().reduced().replace(levels=LEVELS, **kw)


def _geom(i=0):
    return geo.car_surface(geo.sample_params(i))


def _same(a, b):
    assert a.request_id == b.request_id and a.bucket == b.bucket
    assert np.array_equal(a.points, b.points)
    assert np.array_equal(a.fields, b.fields)


# ------------------------------------------------------- specs and the file

def _ms(cls_ms, cls_grid):
    return cls_ms(level_sizes=(32, 64), k=6, grids=(
        cls_grid(n_points=32, k=6, resolution=(2, 3, 4), neigh_cap=40,
                 layout="csr"),
        cls_grid(n_points=64, k=6, resolution=(4, 5, 6), neigh_cap=50,
                 layout="csr")))


def test_multiscale_spec_round_trips_and_packs_as_jax():
    ms = _ms(MultiscaleSpec, GridSpec)
    packed = artifact.pack_multiscale_spec(ms)
    assert artifact.unpack_multiscale_spec(packed) == ms
    assert packed == jartifact.pack_multiscale_spec(
        _ms(JMultiscaleSpec, JGridSpec))
    assert artifact.ARTIFACT_FORMAT == jartifact.ARTIFACT_FORMAT


def test_shard_spec_round_trips():
    """The frozen ShardSpec (topology, per-shard grids, halo width)
    survives pack/unpack with the same program signature."""
    verts, faces = _geom(1)
    pts, nrm = sample_surface(verts, faces, 128, np.random.default_rng(0))
    spec = sharded.shard_spec_for(128, 2, 2, 1.3, reference_points=pts,
                                  reference_normals=nrm,
                                  level_sizes=(64, 128), k=4)
    back = artifact.unpack_shard_spec(artifact.pack_shard_spec(spec))
    assert back == spec and back.signature() == spec.signature()
    assert back.halo_width == spec.halo_width > 0.0


@pytest.mark.parametrize("kind", ["none", "bin", "list_of_maps"])
def test_codec_carries_what_artifacts_hold(tmp_path, kind):
    """JAX artifacts carry None (``norm_in``), bin (``aot``) and lists of
    maps (``grids``): each travels both ways between the packages' codecs."""
    value = {"none": None, "bin": b"\x00\xffAOT" * 100,
             "list_of_maps": [{"n_points": 64, "resolution": [4, 5, 6]},
                              {"layout": "csr", "k": 6}]}[kind]
    p_port, p_jax = str(tmp_path / "port.msgpack"), str(tmp_path / "j.msgpack")
    ckpt.save(p_port, {"v": value})
    jckpt.save(p_jax, {"v": value})
    assert jckpt.restore(p_port)["v"] == value
    assert ckpt.restore(p_jax)["v"] == value


def test_load_artifact_refuses_a_checkpoint_and_a_corrupt_file(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ckpt.save(p, {"params": {}, "opt": {"step": 3}})
    with pytest.raises(ValueError, match="not a deploy artifact"):
        artifact.load_artifact(p)
    with pytest.raises(ValueError, match="not a deploy artifact"):
        GNNServer.from_artifact(p, device="cpu")
    good = str(tmp_path / "deploy.msgpack")
    GNNServer(_cfg(), (64,), max_batch=1, device="cpu").save_artifact(good)
    raw = Path(good).read_bytes()
    bad = tmp_path / "cut.msgpack"
    bad.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ckpt.CheckpointError):
        artifact.load_artifact(str(bad))


# ------------------------------------------------------------ the server

def test_from_artifact_serves_bit_equal_to_the_source(tmp_path):
    verts, faces = _geom(2)
    src = GNNServer(_cfg(), (128, 256), max_batch=2, seed=5, device="cpu")
    want = src.serve([(verts, faces, 100), (verts, faces, 256),
                      (verts, faces, 128)])
    path = str(tmp_path / "deploy.msgpack")
    info = src.save_artifact(path)
    assert info["buckets"] == [128, 256] and info["aot_buckets"] == []
    tree = ckpt.restore(path)
    assert tree["format"] == artifact.ARTIFACT_FORMAT
    assert tree["backend"] == "cpu" and tree["aot"] == {}
    assert tree["knobs"]["max_batch"] == 2 and tree["knobs"]["seed"] == 5

    dst = GNNServer.from_artifact(path, device="cpu")
    assert (dst.max_batch, dst.seed, dst.ladder()) == (2, 5, (128, 256))
    assert dst.cfg == src.cfg
    got = dst.serve([(verts, faces, 100), (verts, faces, 256),
                     (verts, faces, 128)])
    for a, b in zip(sorted(got, key=lambda r: r.request_id),
                    sorted(want, key=lambda r: r.request_id)):
        _same(a, b)
    rep = dst.stats.report()
    assert rep["bucket_calibrations"] == 0
    assert rep["bucket_compiles"] == 0 and rep["cache_loads"] == 0


def test_restore_carries_the_learned_state_and_never_calibrates(tmp_path):
    """The auto ladder, the request-size histogram and every calibrated spec
    come back; neither the restore nor a later evict->rebuild calibrates."""
    verts, faces = _geom()
    cfg = _cfg(bucket_granularity=64, max_live_buckets=2,
               bucket_refit_every=4)
    src = GNNServer(cfg, "auto", max_batch=1, seed=1, device="cpu")
    for n in (64, 128, 192, 64, 128):
        src.serve([(verts, faces, n)])
    path = str(tmp_path / "deploy.msgpack")
    src.save_artifact(path)

    dst = GNNServer.from_artifact(path, device="cpu")
    assert dst.auto and dst.cfg.bucket_policy == "auto"
    assert dst.target_ladder() == src.target_ladder()
    assert dst.ladder() == src.ladder()
    assert list(dst._size_hist) == list(src._size_hist)
    assert dst._calib == src._calib and set(dst._calib) >= {64, 128, 192}
    for n in (192, 64, 128, 192):                # evictions and rebuilds
        [r] = dst.serve([(verts, faces, n)])
        assert r.error is None
    rep = dst.stats.report()
    assert rep["bucket_evictions"] >= 2
    assert rep["bucket_calibrations"] == 0


def test_sharded_restore_reuses_its_shard_specs(tmp_path):
    verts, faces = _geom(1)
    src = GNNServer(_cfg(), (128,), max_batch=1, seed=3, shard_devices=2,
                    device="cpu")
    [want] = src.serve([(verts, faces, 128)])
    path = str(tmp_path / "deploy.msgpack")
    src.save_artifact(path)
    dst = GNNServer.from_artifact(path, device="cpu")
    assert dst.shard_devices == 2
    assert dst._shard_calib == src._shard_calib
    [got] = dst.serve([(verts, faces, 128)])
    _same(got, want)
    assert dst.stats.report()["bucket_calibrations"] == 0
    # another shard count cannot use the saved specs: it calibrates
    other = GNNServer.from_artifact(path, device="cpu", shard_devices=4)
    assert other._shard_calib[128].n_shards == 4
    assert other.stats.report()["bucket_calibrations"] == 1


def test_jax_only_knobs(tmp_path):
    """The JAX server's compile knobs are read and ignored; ``n_levels``
    and ``check_requests`` are the port server's own knobs too: a
    2-level server's artifact restores a 2-level server, uncalibrated,
    with bit-equal fields."""
    path = str(tmp_path / "deploy.msgpack")
    verts, faces = _geom(1)
    src = GNNServer(_cfg(), (64,), max_batch=1, n_levels=2, device="cpu")
    [want] = src.serve([(verts, faces, 64)])
    src.save_artifact(path)
    srv = GNNServer.from_artifact(path, device="cpu", check_requests=False,
                                  knn_impl="pallas", interpret=False,
                                  donate=False)
    assert srv.ladder() == (64,)
    assert srv.n_levels == 2 and not srv.check_requests
    assert srv._calib[64].level_sizes == (32, 64)
    [got] = srv.serve([(verts, faces, 64)])
    _same(got, want)
    assert srv.stats.report()["bucket_calibrations"] == 0


def _jax_pair(seed=5):
    jcfg = JaxGNNConfig().reduced().replace(levels=LEVELS)
    return jcfg, JaxGNNServer(jcfg, (128,), max_batch=2, seed=seed)


def test_serves_a_jax_written_artifact(tmp_path):
    """JAX's ``save_artifact`` (AOT blobs, where its backend serializes
    them, dropped here): the port serves the same request within 1e-4 of
    that JAX server's own fields, on the same sampled points, with no
    calibration."""
    verts, faces = _geom(2)
    _, jsrv = _jax_pair()
    [want] = jsrv.serve([(verts, faces, 100)])
    path = str(tmp_path / "jax_deploy.msgpack")
    jsrv.save_artifact(path)
    assert artifact.load_artifact(path)["aot"] == {}
    dst = GNNServer.from_artifact(path, device="cpu")
    assert dst.max_batch == 2 and dst.seed == 5 and dst.ladder() == (128,)
    [got] = dst.serve([(verts, faces, 100)])
    assert got.request_id == want.request_id
    assert np.array_equal(got.points, np.asarray(want.points))
    np.testing.assert_allclose(got.fields, np.asarray(want.fields),
                               rtol=0, atol=ATOL)
    assert dst.stats.report()["bucket_calibrations"] == 0


def test_jax_restores_a_port_written_artifact(tmp_path):
    verts, faces = _geom(2)
    src = GNNServer(_cfg(), (128,), max_batch=2, seed=5, device="cpu")
    [want] = src.serve([(verts, faces, 100)])
    path = str(tmp_path / "deploy.msgpack")
    src.save_artifact(path)
    jsrv = JaxGNNServer.from_artifact(path)
    assert jsrv.max_batch == 2 and jsrv.ladder() == (128,)
    [got] = jsrv.serve([(verts, faces, 100)])
    np.testing.assert_allclose(np.asarray(got.fields), want.fields,
                               rtol=0, atol=ATOL)
    assert jsrv.stats.report()["bucket_calibrations"] == 0


_CHILD = """
import hashlib, json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.data import geometry as geo
from repro_torch.launch.serve_gnn import GNNServer
srv = GNNServer.from_artifact(sys.argv[1], device="cpu")
verts, faces = geo.car_surface(geo.sample_params(2))
[r] = srv.serve([(verts, faces, 100)])
rep = srv.stats.report()
print(json.dumps({"fields": hashlib.sha256(r.fields.tobytes()).hexdigest(),
                  "calibrations": rep["bucket_calibrations"],
                  "seconds": time.perf_counter() - t0}))
"""


def test_a_child_process_restores_under_a_time_limit(tmp_path):
    verts, faces = _geom(2)
    src = GNNServer(_cfg(), (128,), max_batch=2, seed=5, device="cpu")
    [want] = src.serve([(verts, faces, 100)])
    path = str(tmp_path / "deploy.msgpack")
    src.save_artifact(path)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _CHILD, path], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=CHILD_TIMEOUT).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["fields"] == hashlib.sha256(want.fields.tobytes()).hexdigest()
    assert res["calibrations"] == 0


def test_cli_saves_and_restores(tmp_path, capsys, build_dir):
    path = str(tmp_path / "deploy.msgpack")
    serve_gnn.main(["--reduced", "--buckets", "256", "--requests", "2",
                    "--device", "cpu", "--save-artifact", path])
    assert "calibrations 1" in capsys.readouterr().out
    serve_gnn.main(["--device", "cpu", "--artifact", path, "--requests",
                    "2", "--compile-cache", str(tmp_path / "kernels")])
    out = capsys.readouterr().out
    assert "restored deploy artifact" in out and "calibrations 0" in out
    assert _build.BUILD_DIR == tmp_path / "kernels"


def test_trainer_cli_enables_the_cache(tmp_path, capsys, build_dir):
    cache = tmp_path / "kernels"
    train.main(["--arch", "xmgn-drivaer", "--reduced", "--steps", "1",
                "--samples", "2", "--device", "cpu", "--compile-cache",
                str(cache)])
    assert '"pressure"' in capsys.readouterr().out
    assert _build.BUILD_DIR == cache
    assert compile_cache.enabled_dir() == str(cache)


# ------------------------------------------------------- the compile cache

def test_enable_is_idempotent_and_the_last_caller_wins(build_dir, caplog):
    before = _build.BUILD_DIR
    assert compile_cache.enable(None) is False
    assert compile_cache.enable("") is False and _build.BUILD_DIR == before
    a, b = str(build_dir / "a"), str(build_dir / "b")
    assert compile_cache.enable(a) is True
    assert _build.BUILD_DIR == Path(a) and compile_cache.enabled_dir() == a
    with caplog.at_level("WARNING", logger=compile_cache.__name__):
        assert compile_cache.enable(a) is True
        assert not caplog.records
        assert compile_cache.enable(b) is True
    assert any("moving from" in r.getMessage() for r in caplog.records)
    assert _build.BUILD_DIR == Path(b) and compile_cache.enabled_dir() == b
    assert compile_cache.enable("") is True and _build.BUILD_DIR == Path(b)


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
open(args[args.index("-o") + 1], "wb").write(b"lib")
"""


@pytest.fixture
def fake_kernel(build_dir, monkeypatch):
    """One kernel source, a stand-in ``nvcc`` that writes its library, and
    a stand-in loader (the library is not a real shared object)."""
    bin_dir = build_dir / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(build_dir / "cuda"))
    src = build_dir / "k.cu"
    src.write_text("// k\n")
    monkeypatch.setattr(_build, "SOURCES", {"k": src})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return build_dir


def test_compile_events_count_builds_and_disk_loads(fake_kernel):
    compile_cache.enable(str(fake_kernel / "cache"))
    ev = compile_cache.CompileEvents()
    _build.load("k")
    assert ev.delta() == (1, 0)               # nvcc ran
    _build.load("k")
    assert ev.delta() == (1, 0)               # already loaded: nothing
    _build._libs.clear()                       # a restarted process
    ev.snapshot()
    _build.load("k")
    assert ev.delta() == (0, 1)               # found on disk
    assert _build.library_path("k").parent == fake_kernel / "cache"


def test_server_counts_a_buckets_first_call(fake_kernel, monkeypatch):
    """``bucket_compiles`` / ``cache_loads`` are the kernels a bucket's
    first call built or loaded, with their ``compile`` / ``cache_load``
    stage; later calls and other buckets count nothing more."""
    real = serve_gnn.make_batched_infer_fn

    def loading(*a, **kw):
        infer = real(*a, **kw)

        def call(*args):
            _build.load("k")                   # as a kernel wrapper does
            return infer(*args)
        return call
    monkeypatch.setattr(serve_gnn, "make_batched_infer_fn", loading)
    cfg = _cfg(compile_cache_dir=str(fake_kernel / "cache"))
    verts, faces = _geom()
    fresh = GNNServer(cfg, (64, 128), max_batch=1, device="cpu")
    fresh.serve([(verts, faces, 64), (verts, faces, 128),
                 (verts, faces, 64)])
    rep = fresh.stats.report()
    assert (rep["bucket_compiles"], rep["cache_loads"]) == (1, 0)
    assert rep["stages"]["compile"]["count"] == 1
    assert rep["stages"]["cache_load"]["count"] == 0
    _build._libs.clear()                       # a restarted process
    warm = GNNServer(cfg, (64,), max_batch=1, device="cpu")
    warm.serve([(verts, faces, 64)])
    rep = warm.stats.report()
    assert (rep["bucket_compiles"], rep["cache_loads"]) == (0, 1)
    assert rep["stages"]["cache_load"]["count"] == 1
