"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` file with a plain C interface under its
package's ``csrc/``. It is compiled for Hopper (``sm_90a``) into its own
shared library under ``build/kernels/`` at the repository root, once, at
first use; the library's file name carries a hash of the source and flags,
so an edited source is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them. Nothing is built or loaded when this module is imported.

``BUILD_DIR`` is the port's compile cache: ``repro_torch.ckpt.
compile_cache.enable`` points it elsewhere, and a restarted process that
finds a library there loads it instead of running ``nvcc``. ``counts``
holds the process's totals: ``misses``, one per ``nvcc`` run that
succeeded, and ``hits``, one per library :func:`load` found on disk.
:func:`plain` is the wrappers' dispatch: the plain version for a tensor
on the CPU, and for every tensor inside :func:`dry_run` (the dry run's
fake tensors have no memory for a kernel to read); a kernel for every
other tensor; it raises on a fake one.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

SOURCES: Dict[str, Path] = {
    "segment_sum": _KERNELS / "segment_agg" / "csrc" / "segment_sum.cu",
    "knn_topk": _KERNELS / "knn" / "csrc" / "knn_topk.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "flash_attention_wgmma": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention_wgmma.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
counts = {"misses": 0, "hits": 0}     # guarded by _lock


class Compiled(NamedTuple):
    log: str          # nvcc's output: -Xptxas -v registers, smem, spills
    seconds: float    # from the start of all compiles to this one's end


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({home}); the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Compiled]:
    """Compile the named kernels (default: all) that are not built yet.

    All ``nvcc`` processes start together. Returns ``{name: Compiled}`` for
    the kernels compiled by this call; raises if any compile fails.
    """
    names = list(SOURCES if names is None else names)
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, Compiled]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, done = {}, {}

    def wait(name, proc):
        out, _ = proc.communicate()
        done[name] = Compiled(out, time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        waiters = [threading.Thread(target=wait, args=(n, proc))
                   for n, (_, proc) in procs.items()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed = []
        for n, (tmp, proc) in procs.items():
            library_path(n).with_suffix(".log").write_text(done[n].log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {SOURCES[n]} "
                              f"(exit {proc.returncode}):\n{done[n].log}")
            else:
                os.replace(tmp, library_path(n))
                counts["misses"] += 1
        if failed:
            raise RuntimeError("\n".join(failed))
        return done
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            on_disk = library_path(name).exists()
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            if on_disk:
                counts["hits"] += 1
        return lib


# depth of nested dry_run() contexts; a module global, not a thread-local,
# because autograd runs a card tensor's backward on a thread of its own
_dry_run_depth = 0


@contextlib.contextmanager
def dry_run():
    """Shapes only (``launch.dryrun``'s step under ``FakeTensorMode``):
    while active, every wrapper takes its plain version whatever its
    tensors' device, and the segment-sum references take their shape-only
    form on a fake tensor. Outside it both raise on a fake tensor."""
    global _dry_run_depth
    _dry_run_depth += 1
    try:
        yield
    finally:
        _dry_run_depth -= 1


def in_dry_run() -> bool:
    return _dry_run_depth > 0


def plain(t) -> bool:
    """Whether a wrapper takes its plain PyTorch version for ``t``: ``t`` on
    the CPU, or any ``t`` inside :func:`dry_run`. A fake tensor on the card
    outside it raises: a kernel would read a null pointer."""
    if t.device.type == "cpu" or in_dry_run():
        return True
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(t):
        raise RuntimeError(
            "a fake tensor on the card outside kernels._build.dry_run(): it "
            "has no memory for a kernel to read")
    return False


def check(status: int, what: str):
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
