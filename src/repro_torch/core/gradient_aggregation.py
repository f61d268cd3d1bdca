"""Gradient aggregation across partitions (paper SIII-A).

Each partition is a self-contained batch; gradients from all partitions are
summed before the optimizer step, which makes partitioned training
*equivalent* to full-graph training. Port of ``repro.core.
gradient_aggregation``, in two modes:

* sequential (one device): autograd accumulates each partition's
  ``backward()`` into ``.grad``, which takes the place of the JAX package's
  ``scan_aggregate_gradients``;
* data-parallel (one process per rank, ``torch.distributed``):
  :func:`ddp_aggregate_gradients`, the twin of
  ``shard_map_aggregate_gradients``: each rank runs the sequential mode over
  its own partitions, then ONE ``all_reduce`` sums the loss and every
  gradient across the ranks.

Every collective of the port's trainers goes through :func:`all_reduce`,
which counts them (``all_reduce.collectives``, beside the kernels'
``.launches`` counters), with their bytes and seconds.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.halo import Partition
from repro_torch.telemetry import span


def partition_batch(part: Partition, node_feats: np.ndarray,
                    edge_feats: np.ndarray, targets: np.ndarray) -> dict:
    """Gather a partition's local arrays from the full-graph arrays."""
    mask = part.owned_mask().astype(np.float32)
    return {
        "node_feats": node_feats[part.global_nodes],
        "edge_feats": edge_feats[part.edge_ids],
        "senders": part.senders,
        "receivers": part.receivers,
        "targets": targets[part.global_nodes],
        "loss_mask": mask,
    }


def padded_partition_batches(padded: dict, node_feats: np.ndarray,
                             edge_feats: np.ndarray,
                             targets: np.ndarray) -> dict:
    """Stacked (P, ...) batches from ``halo.pad_partitions`` output: one
    shape for every partition of every sample."""
    return {
        "node_feats": node_feats[padded["nodes_global"]]
        * padded["node_mask"][..., None],
        "edge_feats": edge_feats[padded["edge_ids"]]
        * padded["edge_mask"][..., None],
        "senders": padded["senders"],
        "receivers": padded["receivers"],
        "targets": targets[padded["nodes_global"]],
        "loss_mask": padded["owned_mask"],
        "edge_mask": padded["edge_mask"],
    }


def aggregate_gradients(loss_fn: Callable, model: torch.nn.Module,
                        batches: Iterable[dict]):
    """Sequential gradient aggregation: the sum of per-partition losses,
    with the sum of their gradients left in each parameter's ``.grad``.

    ``loss_fn(model, batch) -> loss`` must normalize by the *global*
    denominator so the sums reproduce full-graph quantities. Each
    partition's graph is freed by its own ``backward()`` before the next
    one is built, each partition's forward and backward in a
    ``forward_backward`` span. Returns the summed loss, detached.
    """
    for p in model.parameters():
        p.grad = None
    total = None
    for i, b in enumerate(batches):
        with span("forward_backward", partition=i):
            loss = loss_fn(model, b)
            loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place, and return it.

    Counts one collective in ``all_reduce.collectives``, the tensor's bytes
    in ``all_reduce.bytes`` and the host seconds until the sum is on the
    device in ``all_reduce.seconds`` (on the card the device is
    synchronized before and after the call, so the seconds are the
    collective's alone)."""
    cuda = t.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if cuda:
        torch.cuda.synchronize(t.device)
    all_reduce.seconds += time.perf_counter() - t0
    all_reduce.collectives += 1
    all_reduce.bytes += t.numel() * t.element_size()
    return t


all_reduce.collectives = 0
all_reduce.bytes = 0
all_reduce.seconds = 0.0


def all_reduce_loss_and_grads(loss, model: torch.nn.Module, group):
    """One ``all_reduce`` of a flat f32 buffer holding ``loss`` and every
    gradient in ``model.leaves()`` order (the JAX pytree's leaf order); the
    sums are copied back into each ``.grad`` and the summed loss returned.
    A rank that computed nothing (``loss`` None, no ``.grad``) adds zeros,
    which is exact."""
    params = [p for _, p in model.leaves()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if loss is None:
        loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    flat = torch.cat([loss.reshape(1).to(torch.float32)]
                     + [p.grad.reshape(-1) for p in params])
    all_reduce(flat, group)
    off = 1
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p))
        off += n
    return flat[0].clone()


def ddp_aggregate_gradients(loss_fn: Callable, model: torch.nn.Module,
                            batches: Iterable[dict], group):
    """Partition-parallel twin of :func:`aggregate_gradients`: this rank's
    partitions one after another, then one collective a step
    (:func:`all_reduce_loss_and_grads`). Every rank of ``group`` must call
    it once a step, a rank without partitions too. Returns the loss summed
    over every rank's partitions; ``.grad`` holds the summed gradients, the
    same on every rank."""
    loss = aggregate_gradients(loss_fn, model, batches)
    return all_reduce_loss_and_grads(loss, model, group)
