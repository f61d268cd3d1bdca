"""Process groups and partition placement for multi-process GNN training.

Port of the GNN helpers of ``repro.launch.sharding``. Where the JAX package
runs one process over a 1-axis device mesh, the port runs one process per
rank under ``torch.distributed``:

* :func:`shard_count_for` is JAX's rule: the largest rank count that
  divides the partition count (P = 21 on 8 ranks trains 7-way);
* :func:`init_process_group` takes the place of ``mesh_for_shards``: it
  joins this process to a group of ``world_size`` ranks;
* :func:`rank_device` maps a local rank to its card;
* :func:`shard_put` is the rank's part of ``shard_put``: rank r takes
  partitions ``[r P / n, (r + 1) P / n)`` of a stacked (P, ...) batch, as
  ``PartitionSpec(axis)`` places them; a rank at or past ``n`` takes none.

The LLM rules of that module (parameter, optimizer-state, batch and cache
specs) wait for a multi-rank LLM trainer: ``launch.train.train_llm`` runs
in one process on one device.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=120)


def shard_count_for(n_items: int, world: int,
                    limit: Optional[int] = None) -> int:
    """Largest rank count, at most ``world`` (and ``limit``), that divides
    ``n_items``. ``limit=1`` puts every partition on rank 0."""
    n = world if limit is None else min(world, max(int(limit), 1))
    d = max(min(n, n_items), 1)
    while n_items % d:
        d -= 1
    return d


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       backend: Optional[str] = None, device="cuda",
                       timeout: timedelta = DEFAULT_TIMEOUT):
    """Join this process to the default group as ``rank`` of
    ``world_size`` and return the group. ``backend`` defaults to ``nccl``
    for a ``cuda`` device and ``gloo`` for the CPU; ``init_method`` is a
    ``file://`` or ``tcp://`` address (``env://`` under ``torchrun``).
    ``timeout`` bounds the rendezvous and every collective."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dist.group.WORLD


def rank_device(local_rank: int) -> torch.device:
    """The card of local rank ``local_rank``: ranks past the card count
    share cards in turn."""
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: CUDA is not available; run the "
                           "ranks on the CPU with device='cpu'")
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def shard_range(n_items: int, rank: int, n_shards: int) -> range:
    """The partitions of ``rank`` when ``n_shards`` ranks split
    ``n_items`` evenly (empty for a rank at or past ``n_shards``)."""
    if n_items % n_shards:
        raise ValueError(f"{n_items} partitions do not split over "
                         f"{n_shards} ranks")
    per = n_items // n_shards
    if rank >= n_shards:
        return range(0)
    return range(rank * per, (rank + 1) * per)


def shard_put(batch: dict, rank: int, n_shards: int,
              device: Union[str, torch.device]) -> dict:
    """Rank ``rank``'s slice of a stacked (P, ...) batch of numpy arrays,
    as tensors on ``device``."""
    n_items = next(iter(batch.values())).shape[0]
    part = shard_range(n_items, rank, n_shards)
    dev = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[part.start:part.stop])).to(dev) for k, v in batch.items()}
