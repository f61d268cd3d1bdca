"""Msgpack pytree checkpoints, in the JAX package's format, on PyTorch.

A port of ``repro.ckpt.checkpoint``: the same file layout, so each package
reads the other's checkpoints. Arrays are serialized as ``{"__ndarray__":
True, "dtype": <numpy dtype name>, "shape": [...], "data": <raw bytes>}``,
tuples as ``{"__tuple__": [...]}``, the tree as nested msgpack maps and
arrays. A leaf may be a ``torch.Tensor`` (on any device) or a numpy array;
arrays come back as CPU ``torch`` tensors. ``bfloat16`` travels as its raw
16-bit words under the dtype name ``"bfloat16"`` (the JAX package reads it
with ``ml_dtypes``; here its words are read as ``int16`` and viewed as
``torch.bfloat16``, with no ``ml_dtypes``). The
msgpack codec is the port's own (:mod:`repro_torch.ckpt._msgpack`): the
``msgpack`` package is not needed.

Durability: :func:`save` writes a temp file in the target directory,
fsyncs it, ``os.replace``-s it over the target and fsyncs the directory, so
a crash never durably publishes a truncated checkpoint. :func:`restore`
raises :class:`CheckpointError` on a corrupt or truncated payload.

Async writes: :class:`AsyncCheckpointer` copies the tree to the host on the
calling thread (a blocking ``.detach().to("cpu", copy=True)`` per tensor:
the trainer updates its parameters in place, so a reference or a
non-blocking copy would let a later step's weights into the file) and
serializes, fsyncs and renames on a background thread.
"""
from __future__ import annotations

import glob
import os
import re
import tempfile
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import _msgpack
from repro_torch.resilience import faults

_ARR = "__ndarray__"
_TUP = "__tuple__"
_BF16 = "bfloat16"


class CheckpointError(ValueError):
    """A checkpoint file is corrupt, truncated, or not a checkpoint."""


def _array_record(dtype: str, shape, data: np.ndarray) -> dict:
    """The ``__ndarray__`` map; ``data`` is passed as a ``memoryview`` of
    the array's bytes, so the writer copies them once, into the file."""
    return {_ARR: True, "dtype": dtype, "shape": list(shape),
            "data": memoryview(np.ascontiguousarray(data).reshape(-1)
                               .view(np.uint8))}


def _pack(obj: Any):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _array_record(_BF16, t.shape, t.view(torch.int16).numpy())
        a = t.numpy()
        return _array_record(a.dtype.name, a.shape, a)
    if isinstance(obj, np.ndarray):
        return _array_record(obj.dtype.name, obj.shape, obj)
    if isinstance(obj, dict):
        return {str(k): _pack(v) for k, v in obj.items()}
    if isinstance(obj, tuple):         # NamedTuples included
        return {_TUP: [_pack(v) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, (bytes, int, float, str, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    raise TypeError(f"cannot checkpoint object of type {type(obj)}")


def _tensor(rec: dict) -> torch.Tensor:
    """One ``__ndarray__`` record as a CPU tensor; its bytes (a view of the
    payload) are copied once."""
    shape = [int(n) for n in rec["shape"]]
    if rec["dtype"] == _BF16:
        words = np.frombuffer(rec["data"], np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    a = np.frombuffer(rec["data"], np.dtype(rec["dtype"])).reshape(shape)
    return torch.from_numpy(a.copy())


def _unpack(obj: Any):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            return _tensor(obj)
        if _TUP in obj:
            return tuple(_unpack(v) for v in obj[_TUP])
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    if isinstance(obj, memoryview):
        return bytes(obj)
    return obj


def save(path: str, tree: Any) -> None:
    """Atomically AND durably write a pytree checkpoint.

    Write to a temp file in the target directory, flush + fsync the file,
    ``os.replace`` it over ``path``, then fsync the directory so the rename
    itself is durable. Without the fsyncs a crash between the rename
    reaching disk and the data reaching disk would publish a truncated
    file under the final name.
    """
    chunks = _msgpack.pack_chunks(_pack(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    faults.fire("ckpt.write")       # chaos: crash before any byte lands
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            for c in chunks:
                f.write(c)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("ckpt.rename")  # chaos: crash between write and publish
        os.replace(tmp, path)
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path: str) -> Any:
    """Read a checkpoint; raise :class:`CheckpointError` if it is corrupt.

    Arrays come back as CPU ``torch`` tensors; ints, floats, strings, bytes
    and ``None`` as Python values; tuples as tuples.
    """
    with open(path, "rb") as f:
        raw = f.read()
    try:
        obj = _msgpack.unpackb(raw, bin_views=True)
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path!r} is corrupt or truncated "
            f"({len(raw)} bytes): {type(e).__name__}: {e}") from e
    try:
        return _unpack(obj)
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path!r} decoded but its payload is malformed: "
            f"{type(e).__name__}: {e}") from e


# --------------------------------------------------- retention / fallback

_STEP_RE = re.compile(r"\.step(\d+)$")


def retained_path(path: str, step: int) -> str:
    """The step-tagged sibling ``<path>.stepNNNNNNNN`` of a checkpoint."""
    return f"{path}.step{int(step):08d}"


def retained_steps(path: str) -> List[Tuple[int, str]]:
    """Existing step-tagged siblings of ``path`` as ``(step, path)``,
    ascending by step."""
    out = []
    for p in glob.glob(glob.escape(path) + ".step*"):
        m = _STEP_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def prune_retained(path: str, keep: int) -> List[str]:
    """Delete step-tagged siblings beyond the ``keep`` newest; returns the
    deleted paths. ``keep <= 0`` prunes nothing (unbounded retention)."""
    if keep <= 0:
        return []
    doomed = [p for _, p in retained_steps(path)[:-keep]]
    for p in doomed:
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass                      # a concurrent prune got there first
    return doomed


def save_retained(path: str, tree: Any, step: int, keep: int) -> str:
    """Write ``tree`` to the step-tagged sibling of ``path`` and prune the
    retention window down to ``keep`` files. Returns the written path."""
    p = retained_path(path, step)
    save(p, tree)
    prune_retained(path, keep)
    return p


def restore_with_fallback(path: str) -> Tuple[Any, str, List[str]]:
    """Restore ``path``, falling back past corrupt checkpoints.

    Candidates are ``path`` itself plus every step-tagged retention
    sibling, tried newest-first (mtime order, step as tiebreak). A
    candidate that raises :class:`CheckpointError` is skipped; the first
    intact one wins. Returns ``(tree, used_path, skipped_paths)``. Raises
    :class:`CheckpointError` if no candidate survives.
    """
    by_step = {p: s for s, p in retained_steps(path)}
    cand = ([path] if os.path.exists(path) else []) + sorted(by_step)
    if not cand:
        raise CheckpointError(f"no checkpoint found at {path!r} "
                              "(no file, no retained .stepNNN siblings)")
    cand.sort(key=lambda p: (os.path.getmtime(p), by_step.get(p, -1)),
              reverse=True)
    skipped: List[str] = []
    last_err: Optional[CheckpointError] = None
    for p in cand:
        try:
            return restore(p), p, skipped
        except CheckpointError as e:
            skipped.append(p)
            last_err = e
    raise CheckpointError(
        f"every checkpoint candidate for {path!r} is corrupt "
        f"(tried {cand})") from last_err


def _to_host(obj: Any):
    """A host copy of every array in the tree, made now: tensors by a
    blocking ``.detach().to("cpu", copy=True)``, numpy arrays by a copy
    (a CPU tensor's ``.numpy()`` shares its memory)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return np.array(obj, copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    if hasattr(obj, "_asdict"):  # NamedTuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_to_host(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Background-thread checkpoint writer for long training runs.

    ``save(path, tree)`` copies the tree to the host on the calling thread
    (so the caller may update its tensors in place as soon as it returns)
    and hands the serialize+fsync+rename work to a worker thread; the call
    blocks only until the PREVIOUS write finishes: at most one write is in
    flight, so checkpoints land in order.

    ``wait()`` joins the in-flight write; a failed background write raises
    there (or on the next ``save``) instead of being silently dropped.
    ``on_write`` (optional) receives the wall seconds of each completed
    write, e.g. a telemetry histogram's ``observe``.
    """

    def __init__(self, on_write: Optional[Callable[[float], None]] = None):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._on_write = on_write

    def save(self, path: str, tree: Any) -> None:
        self.wait()                       # at most one write in flight
        host_tree = _to_host(tree)

        def write():
            t0 = time.perf_counter()
            try:
                save(path, host_tree)
            except BaseException as e:    # surfaced on wait()/next save()
                self._error = e
                return
            if self._on_write is not None:
                self._on_write(time.perf_counter() - t0)

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight write (if any) completes; re-raise a
        background failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        # don't mask an in-body exception with a background-write error
        if exc[0] is None:
            self.wait()
        elif self._thread is not None:
            self._thread.join()
            self._thread = None
