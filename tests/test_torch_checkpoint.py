"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's.

* The msgpack codec: the bytes of ``msgpack.packb(obj, use_bin_type=True)``
  and the values of ``msgpack.unpackb``, for trees that cross every size
  threshold of the format (int widths, str/bin 8/16/32, array/map 16/32).
* Cross-reads: a file written by ``repro.ckpt.checkpoint.save`` read by the
  port, and the port's read by JAX, bit-equal, bf16, 0-d int32, tuples and
  bytes included.
* Durability and the async writer, ported from ``tests/test_checkpoint.py``,
  plus an in-place update after ``save`` returns, which must not reach the
  file.
* Retention, fallback and the ``ckpt.write``/``ckpt.rename`` fault sites,
  ported from ``tests/test_resilience.py``.
"""
import os
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import _msgpack
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.checkpoint import AsyncCheckpointer, CheckpointError
from repro_torch.optim.adam import AdamState
from repro_torch.resilience import FAULTS, FaultError


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


# ------------------------------------------------------------------ codec

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
         2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
         -32769, -2**31, -2**31 - 1, -2**63]
_LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _codec_cases():
    yield "ints", _INTS
    yield "scalars", [None, True, False, 0.0, -0.0, 1.5, -2.25e-300, 1e300,
                      float("inf"), 3]
    for n in _LENGTHS:
        yield f"str{n}", "s" * n
        yield f"utf8_{n}", "é" * n           # 2 bytes a character
        yield f"bin{n}", bytes(range(256)) * (n // 256) + bytes(n % 256)
        yield f"array{n}", list(range(n))
        yield f"map{n}", {f"k{i}": i for i in range(n)}
    yield "nested", {"a": {"b": [1, (2, -3), {"c": b"\x00\xff"}]},
                     "t": ("x", [None, True]), 7: "int key", "": []}


@pytest.mark.parametrize("name,obj", list(_codec_cases()),
                         ids=[n for n, _ in _codec_cases()])
def test_codec_matches_msgpack(name, obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert b"".join(bytes(c) for c in _msgpack.pack_chunks(obj)) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


def test_codec_memoryview_bins():
    a = np.arange(6, dtype=np.float32)
    view = memoryview(a.view(np.uint8))
    assert _msgpack.packb({"d": view}) == msgpack.packb(
        {"d": a.tobytes()}, use_bin_type=True)
    out = _msgpack.unpackb(_msgpack.packb({"d": view}), bin_views=True)
    assert isinstance(out["d"], memoryview) and bytes(out["d"]) == \
        a.tobytes()


@pytest.mark.parametrize("raw", [b"", b"\x81", b"\x92\x01", b"\xc1",
                                 b"\xc4\x05ab", b"\x01\x02",
                                 b"\xca\x3f\xc0\x00\x00"])
def test_codec_rejects_bad_bytes(raw):
    with pytest.raises(_msgpack.UnpackError):
        _msgpack.unpackb(raw)


# ------------------------------------------------------------ cross-reads

def _jax_tree():
    """A tree of every leaf kind a checkpoint holds, as the JAX package
    builds it."""
    rng = np.random.default_rng(0)
    return {"params": {"w": jnp.asarray(rng.normal(size=(3, 4)),
                                        jnp.float32),
                       "b": jnp.asarray(rng.normal(size=(4,)),
                                        jnp.bfloat16),
                       "ids": np.arange(5, dtype=np.int32)},
            "opt": {"step": jnp.asarray(7, jnp.int32),
                    "m": (np.ones((2,), np.float64), np.uint8(3))},
            "step": 12, "lr": 1e-3, "name": "xmgn", "blob": b"\x00\x01",
            "none": None, "flags": [True, False]}


def _port_tree():
    """The same tree as the port builds it (tensors)."""
    j = _jax_tree()
    return {"params": {"w": torch.tensor(np.asarray(j["params"]["w"])),
                       "b": torch.tensor(
                           np.asarray(j["params"]["b"]).view(np.int16))
                       .view(torch.bfloat16),
                       "ids": torch.arange(5, dtype=torch.int32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": (torch.ones((2,), dtype=torch.float64), 3)},
            "step": 12, "lr": 1e-3, "name": "xmgn", "blob": b"\x00\x01",
            "none": None, "flags": [True, False]}


def _check_port_read(got):
    want = _jax_tree()
    p = got["params"]
    assert p["w"].dtype == torch.float32 and p["w"].shape == (3, 4)
    np.testing.assert_array_equal(p["w"].numpy(),
                                  np.asarray(want["params"]["w"]))
    assert p["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["b"].view(torch.int16).numpy(),
        np.asarray(want["params"]["b"]).view(np.int16))
    assert p["ids"].dtype == torch.int32
    assert got["opt"]["step"].dtype == torch.int32
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7
    assert isinstance(got["opt"]["m"], tuple)
    assert got["opt"]["m"][0].dtype == torch.float64
    assert got["opt"]["m"][1] == 3
    assert (got["step"], got["lr"], got["name"], got["blob"], got["none"],
            got["flags"]) == (12, 1e-3, "xmgn", b"\x00\x01", None,
                              [True, False])


def _check_jax_read(got):
    want = _jax_tree()
    for k in ("w", "b", "ids"):
        assert got["params"][k].dtype == want["params"][k].dtype, k
        np.testing.assert_array_equal(np.asarray(got["params"][k]),
                                      np.asarray(want["params"][k]))
    assert got["params"]["b"].dtype == jnp.bfloat16
    assert got["opt"]["step"].dtype == jnp.int32
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7
    assert isinstance(got["opt"]["m"], tuple) and got["opt"]["m"][1] == 3
    assert got["blob"] == b"\x00\x01" and got["none"] is None


def test_port_reads_jax_checkpoint(tmp_path):
    p = str(tmp_path / "jax.msgpack")
    jckpt.save(p, _jax_tree())
    _check_port_read(ckpt.restore(p))


def test_jax_reads_port_checkpoint(tmp_path):
    p = str(tmp_path / "port.msgpack")
    ckpt.save(p, _port_tree())
    _check_jax_read(jckpt.restore(p))


def test_same_tree_same_bytes(tmp_path):
    """One tree written by both packages: the same file, byte for byte
    (both use msgpack's encoding and the same record layout)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jckpt.save(a, _jax_tree())
    ckpt.save(b, _port_tree())
    assert open(a, "rb").read() == open(b, "rb").read()


def test_bf16_roundtrip_every_word(tmp_path):
    """All 65,536 bf16 bit patterns (NaNs included) survive both ways."""
    words = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    p = str(tmp_path / "bf16.msgpack")
    ckpt.save(p, {"x": torch.from_numpy(words.copy()).view(torch.bfloat16)})
    got = jckpt.restore(p)["x"]
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got).view(np.int16), words)
    jckpt.save(p, {"x": np.asarray(words.view(ml_dtypes.bfloat16))})
    back = ckpt.restore(p)["x"]
    np.testing.assert_array_equal(back.view(torch.int16).numpy(), words)


def test_noncontiguous_empty_and_scalar_leaves(tmp_path):
    """A transposed tensor is written in its logical order; a 0-size array
    and a 0-d tensor survive."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
    p = str(tmp_path / "ck")
    ckpt.save(p, {"t": t, "e": np.zeros((0, 3), np.float32),
                  "s": torch.tensor(2.5)})
    got = ckpt.restore(p)
    assert torch.equal(got["t"], t.contiguous())
    assert got["e"].shape == (0, 3) and float(got["s"]) == 2.5
    np.testing.assert_array_equal(np.asarray(jckpt.restore(p)["t"]),
                                  t.numpy())


# ------------------------------------------------- durability, async writer

def _tree():
    return {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": np.zeros((4,), np.float32)},
            "opt": (np.int32(3), [1.0, 2.0]),
            "step": 7, "name": "t", "blob": b"\x00\x01\x02"}


def test_roundtrip_with_bytes_and_scalars(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ckpt.save(p, _tree())
    out = ckpt.restore(p)
    np.testing.assert_array_equal(
        out["params"]["w"].numpy(),
        np.arange(12, dtype=np.float32).reshape(3, 4))
    assert out["step"] == 7 and out["name"] == "t"
    assert out["blob"] == b"\x00\x01\x02"
    assert out["opt"][0] == 3


def test_save_fsyncs_file_and_directory(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real_fsync(fd))[1])
    ckpt.save(str(tmp_path / "ck.msgpack"), {"a": 1})
    assert len(synced) >= 2        # temp file + containing directory


def test_restore_truncated_raises_checkpoint_error(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ckpt.save(p, _tree())
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(CheckpointError, match="corrupt or truncated"):
        ckpt.restore(p)


def test_restore_garbage_raises_checkpoint_error(tmp_path):
    p = str(tmp_path / "junk.msgpack")
    with open(p, "wb") as f:
        f.write(b"\xc1not-msgpack" * 10)
    with pytest.raises(CheckpointError):
        ckpt.restore(p)


def test_restore_error_names_path_and_size(tmp_path):
    p = str(tmp_path / "short.msgpack")
    with open(p, "wb") as f:
        f.write(b"\x81")           # map header with no body
    with pytest.raises(CheckpointError) as ei:
        ckpt.restore(p)
    assert "short.msgpack" in str(ei.value)
    assert "1 bytes" in str(ei.value)


def test_restore_malformed_payload(tmp_path):
    """Valid msgpack whose array record is wrong: CheckpointError."""
    p = str(tmp_path / "bad.msgpack")
    with open(p, "wb") as f:
        f.write(msgpack.packb({"x": {"__ndarray__": True, "dtype": "float32",
                                     "shape": [3], "data": b"\x00" * 4}},
                              use_bin_type=True))
    with pytest.raises(CheckpointError, match="malformed"):
        ckpt.restore(p)


def test_async_checkpointer_writes_and_orders(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    times = []
    w = AsyncCheckpointer(on_write=times.append)
    for step in range(3):
        w.save(p, {"step": step})
    w.wait()
    assert ckpt.restore(p)["step"] == 2       # last write wins, in order
    assert len(times) == 3 and all(t >= 0 for t in times)


def test_async_checkpointer_does_not_block_caller(tmp_path, monkeypatch):
    """save() returns while the (slowed) write is still in flight."""
    gate = threading.Event()
    orig = ckpt.save

    def slow_save(path, tree):
        gate.wait(timeout=10)
        orig(path, tree)

    w = AsyncCheckpointer()
    monkeypatch.setattr(ckpt, "save", slow_save)
    try:
        t0 = time.perf_counter()
        w.save(str(tmp_path / "ck.msgpack"), {"a": 1})
        assert time.perf_counter() - t0 < 5.0     # did not wait for the gate
    finally:
        gate.set()
        w.wait()
    assert ckpt.restore(str(tmp_path / "ck.msgpack"))["a"] == 1


def test_async_checkpointer_surfaces_background_error(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_bytes(b"")
    w = AsyncCheckpointer()
    w.save(str(blocker / "ck.msgpack"), {"a": 1})   # parent is a file
    with pytest.raises(OSError):
        w.wait()
    # the error is consumed: subsequent saves work again
    w.save(str(tmp_path / "ok.msgpack"), {"a": 1})
    w.wait()
    assert ckpt.restore(str(tmp_path / "ok.msgpack"))["a"] == 1


def test_async_checkpointer_context_manager(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    with AsyncCheckpointer() as w:
        w.save(p, {"done": True})
    assert bool(ckpt.restore(p)["done"])


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The trainer updates its parameters in place (``p.copy_``) right
    after a save: the write must hold the values at the call, for a tensor,
    a numpy view of a tensor, and a NamedTuple of tensors."""
    gate = threading.Event()
    orig = ckpt.save

    def slow_save(path, tree):
        gate.wait(timeout=10)
        orig(path, tree)

    p = str(tmp_path / "ck.msgpack")
    param = torch.nn.Parameter(torch.zeros(4, 3))
    view = param.detach().numpy()          # shares the parameter's memory
    opt = AdamState(step=torch.tensor(1, dtype=torch.int32), mu=[param],
                    nu=[param[0]])
    monkeypatch.setattr(ckpt, "save", slow_save)
    w = AsyncCheckpointer()
    try:
        w.save(p, {"p": param, "v": view, "opt": opt})
        with torch.no_grad():
            param.copy_(torch.ones(4, 3))  # the next step, in place
    finally:
        gate.set()
        w.wait()
    got = ckpt.restore(p)
    assert torch.equal(got["p"], torch.zeros(4, 3))
    assert torch.equal(got["v"], torch.zeros(4, 3))
    step, mu, nu = got["opt"]
    assert int(step) == 1 and torch.equal(mu[0], torch.zeros(4, 3))
    assert torch.equal(nu[0], torch.zeros(3))


# ------------------------------------------- fault sites, retention, fallback

def _rtree(x):
    return {"params": {"w": np.full((3, 4), float(x), np.float32)},
            "step": int(x)}


def test_ckpt_write_fault_leaves_target_intact(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ckpt.save(p, _rtree(1))
    raw = open(p, "rb").read()
    for site in ("ckpt.write", "ckpt.rename"):
        FAULTS.arm(site, nth=1, times=1)
        with pytest.raises(FaultError):
            ckpt.save(p, _rtree(2))
        assert open(p, "rb").read() == raw            # old bytes untouched
        assert os.listdir(tmp_path) == ["ck.msgpack"]  # no tmp leftovers
    ckpt.save(p, _rtree(2))                           # disarmed: works again
    assert ckpt.restore(p)["step"] == 2


def test_async_write_fault_surfaces_and_keeps_target(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    ckpt.save(p, _rtree(1))
    raw = open(p, "rb").read()
    w = AsyncCheckpointer()
    with FAULTS.armed("ckpt.rename"):
        w.save(p, _rtree(2))
        with pytest.raises(FaultError):
            w.wait()
    assert open(p, "rb").read() == raw
    assert os.listdir(tmp_path) == ["ck.msgpack"]


def test_retention_prune_keeps_newest_k(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    for step in range(1, 6):
        written = ckpt.save_retained(p, _rtree(step), step, keep=3)
        assert written == ckpt.retained_path(p, step)
    steps = [s for s, _ in ckpt.retained_steps(p)]
    assert steps == [3, 4, 5]
    assert ckpt.prune_retained(p, keep=0) == []       # 0 = keep everything
    assert ckpt.retained_path(p, 7) == jckpt.retained_path(p, 7)


def test_restore_with_fallback_skips_corrupt_newest(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    for i, step in enumerate((1, 2, 3)):
        sib = ckpt.retained_path(p, step)
        ckpt.save(sib, _rtree(step))
        os.utime(sib, (1000 + i, 1000 + i))           # deterministic mtimes
    ckpt.save(p, _rtree(4))
    os.utime(p, (1010, 1010))                         # final file is newest
    tree, used, skipped = ckpt.restore_with_fallback(p)
    assert used == p and tree["step"] == 4 and skipped == []
    # truncate the final path -> newest retained sibling, bit for bit
    raw = open(ckpt.retained_path(p, 3), "rb").read()
    with open(p, "wb") as f:
        f.write(open(p, "rb").read()[:10])
    tree, used, skipped = ckpt.restore_with_fallback(p)
    assert used == ckpt.retained_path(p, 3)
    assert skipped == [p]
    assert open(used, "rb").read() == raw
    np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                  np.full((3, 4), 3.0, np.float32))
    # corrupt that sibling too -> next one back
    with open(ckpt.retained_path(p, 3), "wb") as f:
        f.write(b"\x81")
    tree, used, skipped = ckpt.restore_with_fallback(p)
    assert used == ckpt.retained_path(p, 2) and len(skipped) == 2
    assert tree["step"] == 2


def test_restore_with_fallback_every_candidate_dead(tmp_path):
    p = str(tmp_path / "ck.msgpack")
    with pytest.raises(CheckpointError, match="no checkpoint"):
        ckpt.restore_with_fallback(p)
    with open(p, "wb") as f:
        f.write(b"\x81")
    with pytest.raises(CheckpointError, match="corrupt"):
        ckpt.restore_with_fallback(p)
