"""The paper's core claim, demonstrated end to end: training on halo
partitions with gradient aggregation is EXACTLY equivalent to full-graph
training, while needing only 1/P of the activation memory.

The port's twin of ``examples/partition_equivalence.py``: the same graph
(600 random points from ``default_rng(0)``, 6-NN, 4 message-passing
layers, halo 4), weights drawn from ``--seed``, and the loss and gradient
differences of P = 2, 4 and 8 partitions against the full graph.

Run:  PYTHONPATH=src python -m repro_torch.examples.partition_equivalence \\
          [--seed 0] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import halo, partitioning
from repro_torch.core.gradient_aggregation import (aggregate_gradients,
                                                   partition_batch)
from repro_torch.core.graph_build import knn_edges
from repro_torch.device import resolve
from repro_torch.models import meshgraphnet as mgn

N, K, L = 600, 6, 4
CFG = GNNConfig(node_in=6, edge_in=4, node_out=4, hidden=64,
                n_mp_layers=L, halo=L)


def example_graph():
    """The JAX example's graph and data, from ``default_rng(0)``: ``(pos,
    senders, receivers, node_feats, edge_feats, targets)``."""
    rng = np.random.default_rng(0)
    pos = rng.random((N, 3)).astype(np.float32)
    senders, receivers = knn_edges(pos, K)
    nf = rng.normal(size=(N, 6)).astype(np.float32)
    rel = pos[senders] - pos[receivers]
    ef = np.concatenate([rel, np.linalg.norm(rel, axis=1, keepdims=True)],
                        1).astype(np.float32)
    tg = rng.normal(size=(N, 4)).astype(np.float32)
    return pos, senders, receivers, nf, ef, tg


def _on(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _grads(model) -> list:
    return [p.grad.detach().clone() for p in model.parameters()]


def main(argv=None, params=None) -> dict:
    """Print and return the full graph's loss and, for each P, the loss
    difference, the largest gradient difference and the halo statistics.
    ``params`` (a ``MeshGraphNet`` of ``CFG``) replaces the weights drawn
    from ``--seed``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    pos, senders, receivers, nf, ef, tg = example_graph()
    model = params if params is not None else mgn.init(
        torch.Generator().manual_seed(args.seed), CFG, device=dev)
    model = model.to(dev)
    denom = float(N * 4)

    def loss_fn(m, b):
        return mgn.loss_fn(m, b, denom=denom)
    full = _on({"node_feats": nf, "edge_feats": ef, "senders": senders,
                "receivers": receivers, "targets": tg,
                "loss_mask": np.ones(N, np.float32)}, dev)
    full_loss = float(aggregate_gradients(loss_fn, model, [full]))
    full_grads = _grads(model)

    print(f"full graph: {N} nodes, {len(senders)} edges, "
          f"loss={full_loss:.6f}")
    out = {"full_loss": full_loss, "parts": {}}
    for P in (2, 4, 8):
        labels = partitioning.partition(senders, receivers, N, P,
                                        positions=pos)
        parts = halo.build_partitions(senders, receivers, labels, P, L)
        stats = halo.halo_overhead(parts, N)
        batches = (_on(partition_batch(pp, nf, ef, tg), dev)
                   for pp in parts)
        loss = float(aggregate_gradients(loss_fn, model, batches))
        gdiff = max(float((g - f).abs().max())
                    for g, f in zip(_grads(model), full_grads))
        print(f"P={P}: loss diff={abs(loss - full_loss):.2e}, "
              f"max grad diff={gdiff:.2e}, "
              f"max partition nodes={stats['max_nodes']} "
              f"({stats['max_nodes'] / N:.0%} of full graph), "
              f"halo fraction={stats['halo_fraction']:.0%}")
        out["parts"][P] = {"loss": loss, "loss_diff": abs(loss - full_loss),
                           "max_grad_diff": gdiff, **stats}
    return out


if __name__ == "__main__":
    main()
