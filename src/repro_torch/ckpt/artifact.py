"""Deploy artifacts: everything a restarted server needs to skip cold start.

Port of ``repro.ckpt.artifact``, in the same file format
(``ARTIFACT_FORMAT``), so each package reads the other's artifacts. An
artifact is one durable file (a ``repro_torch.ckpt.checkpoint`` container,
the port's own msgpack codec) bundling a trained server's learned state:

* model params (in the JAX package's tree layout) and normalizer stats,
* the autoscaler's learned state: target ladder, live bucket sizes and the
  request-size histogram, so a restored auto server resumes the adapted
  ladder instead of re-learning traffic,
* per-bucket calibrated grid specs (the host cKDTree calibration) and, for
  a sharded server, per-bucket ``ShardSpec``s, so a restore, or a later LRU
  evict->rebuild, never calibrates again.

The JAX package also ships AOT-serialized executables under ``aot``
(``serialize_compiled`` / ``deserialize_compiled``). The port compiles no
program, so it has neither function: it writes ``aot`` as ``{}``, and drops
the blobs of a JAX artifact when it reads one. What a restarted port
process would compile is its CUDA kernels, which the build directory
caches (``repro_torch.ckpt.compile_cache``).
"""
from __future__ import annotations

import logging

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.graphx.hashgrid import GridSpec
from repro_torch.graphx.multiscale import MultiscaleSpec
from repro_torch.graphx.sharded import ShardSpec

log = logging.getLogger(__name__)

ARTIFACT_FORMAT = "xmgn-deploy-artifact-v1"


# ------------------------------------------------------- spec serialization

def pack_multiscale_spec(ms: MultiscaleSpec) -> dict:
    """MultiscaleSpec -> plain msgpack-able dict (calibration cache entry)."""
    return {
        "level_sizes": list(ms.level_sizes),
        "k": int(ms.k),
        "grids": [{
            "n_points": int(g.n_points), "k": int(g.k),
            "resolution": list(g.resolution),
            "neigh_cap": int(g.neigh_cap), "layout": g.layout,
        } for g in ms.grids],
    }


def unpack_multiscale_spec(d: dict) -> MultiscaleSpec:
    grids = tuple(GridSpec(n_points=int(g["n_points"]), k=int(g["k"]),
                           resolution=tuple(int(r) for r in g["resolution"]),
                           neigh_cap=int(g["neigh_cap"]),
                           layout=str(g["layout"]))
                  for g in d["grids"])
    return MultiscaleSpec(level_sizes=tuple(int(n) for n in d["level_sizes"]),
                          k=int(d["k"]), grids=grids)


def pack_shard_spec(spec: ShardSpec) -> dict:
    """ShardSpec -> plain dict: the shard and halo topology, the per-shard
    multiscale spec and the calibrated halo width, which a restored sharded
    server reuses instead of planning the reference again."""
    return {
        "n_shards": int(spec.n_shards),
        "halo_hops": int(spec.halo_hops),
        "halo_width": float(spec.halo_width),
        "ms": pack_multiscale_spec(spec.ms),
    }


def unpack_shard_spec(d: dict) -> ShardSpec:
    return ShardSpec(n_shards=int(d["n_shards"]),
                     halo_hops=int(d["halo_hops"]),
                     ms=unpack_multiscale_spec(d["ms"]),
                     halo_width=float(d.get("halo_width", 0.0)))


# ----------------------------------------------------------- artifact file

def save_artifact(path: str, tree: dict, backend: str) -> None:
    """Durably write an artifact, stamped with the format and ``backend``
    (the torch device type the server ran on)."""
    tree = dict(tree)
    tree["format"] = ARTIFACT_FORMAT
    tree["backend"] = backend
    ckpt.save(path, tree)


def load_artifact(path: str) -> dict:
    """Read and validate an artifact. Raises :class:`~repro_torch.ckpt.
    checkpoint.CheckpointError` on a corrupt file and ``ValueError`` on a
    checkpoint that is not an artifact. A JAX artifact's AOT executables
    are dropped (``aot`` comes back ``{}``)."""
    tree = ckpt.restore(path)
    if not isinstance(tree, dict) or tree.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{path!r} is not a deploy artifact (format="
            f"{tree.get('format') if isinstance(tree, dict) else None!r}, "
            f"expected {ARTIFACT_FORMAT!r}); train checkpoints load via "
            "GNNServer.from_checkpoint")
    if tree.get("aot"):
        log.info("artifact %s carries %d AOT executables of backend %r; "
                 "the port compiles no program and drops them", path,
                 len(tree["aot"]), tree.get("backend"))
    return dict(tree, aot={})
