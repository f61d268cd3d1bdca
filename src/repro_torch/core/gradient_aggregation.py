"""Gradient aggregation across partitions (paper SIII-A), single device.

Each partition is a self-contained batch; gradients from all partitions are
summed before the optimizer step, which makes partitioned training
*equivalent* to full-graph training. Port of the sequential mode of
``repro.core.gradient_aggregation``: autograd accumulates each partition's
``backward()`` into ``.grad``, which takes the place of the JAX package's
``scan_aggregate_gradients``. The data-parallel mode (one all-reduce per
step) waits for the sharded trainer.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.halo import Partition


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
    one is built. Returns the summed loss, detached.
    """
    for p in model.parameters():
        p.grad = None
    total = None
    for b in batches:
        loss = loss_fn(model, b)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total
