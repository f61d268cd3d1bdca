"""Production meshes as ``torch.distributed`` ``DeviceMesh``es.

Port of ``repro.launch.mesh``. Where the JAX dry run forces 512 host
devices before JAX starts, the port's dry run starts a process group of 512
ranks on the ``fake`` backend (``launch.dryrun.init_fake_world``) before it
builds a mesh: the ranks exist only as numbers, and a collective does
nothing. The mesh's device type is the card's (``"cuda"``) unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks, axes (data, model).
    Multi-pod: 2x16x16 = 512 ranks, axes (pod, data, model).

    Uses the first prod(shape) ranks, so a 512-rank group can build both
    meshes."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} — the dry-run launcher must "
            "start a process group of world size 512 (launch.dryrun."
            "init_fake_world) before it builds a mesh")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(n_data: int | None = None, n_model: int = 1,
                   device_type: str = "cpu"):
    """A small (data, model) mesh over the ranks that exist (tests, CPU
    runs)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = _world()
    if n == 0:
        raise RuntimeError("make_host_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model > n:
        raise RuntimeError(f"need {n_data * n_model} ranks, have {n}")
    return DeviceMesh(device_type,
                      torch.arange(n_data * n_model).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def mesh_context(mesh):
    """JAX activates a mesh for its jits; the port passes meshes
    explicitly, so this is a context that does nothing."""
    del mesh
    return contextlib.nullcontext()


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh (('pod','data') when multi-pod)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
