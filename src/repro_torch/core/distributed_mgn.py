"""Distributed execution of (X-)MeshGraphNet, one process per rank.

Port of ``repro.core.distributed_mgn``: the two schemes of the paper's SIV
comparison, with ``torch.distributed`` process groups in place of the JAX
device mesh and the collectives explicit calls of this package
(``gradient_aggregation.all_reduce``), not ``DistributedDataParallel``
hooks:

1. **X-MGN partitions-as-DDP** (the paper's contribution): each rank owns
   self-contained partitions with their halos; the only communication is
   one ``all_reduce`` of the loss and gradients a step, however many
   message-passing layers there are.
2. **Distributed MeshGraphNet baseline**: the graph is sharded without
   halos; every message-passing layer exchanges the boundary node features
   so that receivers can read remote senders. 2L + 1 collectives a step: L
   exchanges forward, their L transposes backward, and the sum of loss and
   gradients.

Both give the full-graph gradients; they differ only in how they
communicate. On the card the baseline runs the segment-sum kernel for its
aggregation and for the backward of its three gathers (senders from the
local-plus-boundary table, receivers, and the exported boundary rows).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from repro_torch.core.gradient_aggregation import (all_reduce,
                                                   all_reduce_loss_and_grads,
                                                   ddp_aggregate_gradients)
from repro_torch.kernels.segment_agg import ops as segops
from repro_torch.models.meshgraphnet import MeshGraphNet, loss_fn

# --------------------------------------------------------------------------
# Scheme 1: X-MGN, partitions as DDP batches, one all-reduce a step.
# --------------------------------------------------------------------------


def make_xmgn_ddp_grad_fn(group):
    """Returns ``f(model, stacked, denom) -> loss``, the summed gradients
    left in ``.grad``.

    ``stacked`` is this rank's slice of the (P, ...) partition batch
    (``launch.sharding.shard_put``; none for a rank past the partitions):
    the rank runs its partitions one after another, each loss divided by
    the sample's global denominator ``denom``, and the per-rank sums meet
    in one ``all_reduce``."""

    def grad_fn(model: MeshGraphNet, stacked: dict, denom):
        n_parts = stacked["senders"].shape[0]
        batches = ({k: v[p] for k, v in stacked.items()}
                   for p in range(n_parts))
        return ddp_aggregate_gradients(lambda m, b: loss_fn(m, b, denom),
                                       model, batches, group)
    return grad_fn


# --------------------------------------------------------------------------
# Scheme 2: Distributed MeshGraphNet baseline, per-layer boundary exchange.
# --------------------------------------------------------------------------

SHARD_KEYS = ("node_feats", "targets", "node_mask", "edge_feats",
              "edge_mask", "senders_slot", "receivers", "boundary_gather",
              "boundary_mask")


def prepare_dmgn_shards(senders: np.ndarray, receivers: np.ndarray,
                        labels: np.ndarray, n_dev: int,
                        node_feats: np.ndarray, edge_feats: np.ndarray,
                        targets: np.ndarray) -> dict:
    """Shard a graph for distributed message passing (no halo).

    Rank d owns the nodes with ``labels == d`` and every edge whose
    receiver it owns. Senders on other ranks are read from each layer's
    exchanged boundary buffer: every rank exports its owned nodes that send
    across a partition boundary, padded to the largest count B.

    Edge senders index a concatenated table: local slot i for i < Nmax,
    else ``Nmax + d * B + pos`` into the exchanged buffer. The arrays are
    stacked over ranks, (n_dev, ...), as the JAX package's.
    """
    n_nodes = labels.shape[0]
    cross = labels[senders] != labels[receivers]
    boundary_nodes = [np.unique(senders[cross & (labels[senders] == d)])
                      for d in range(n_dev)]
    B = max((len(b) for b in boundary_nodes), default=1) or 1
    Nmax = int(np.bincount(labels, minlength=n_dev).max())
    Emax = int(np.bincount(labels[receivers], minlength=n_dev).max())

    # global node -> (rank, local slot) and -> boundary slot
    local_of = np.full(n_nodes, -1, np.int64)
    for d in range(n_dev):
        own = np.where(labels == d)[0]
        local_of[own] = np.arange(len(own))
    bslot_of = np.full(n_nodes, -1, np.int64)
    for d, b in enumerate(boundary_nodes):
        bslot_of[b] = d * B + np.arange(len(b))

    out = {
        "node_feats": np.zeros((n_dev, Nmax, node_feats.shape[1]),
                               np.float32),
        "targets": np.zeros((n_dev, Nmax, targets.shape[1]), np.float32),
        "node_mask": np.zeros((n_dev, Nmax), np.float32),
        "edge_feats": np.zeros((n_dev, Emax, edge_feats.shape[1]),
                               np.float32),
        "edge_mask": np.zeros((n_dev, Emax), np.float32),
        "senders_slot": np.zeros((n_dev, Emax), np.int32),  # [0, Nmax + n B)
        "receivers": np.zeros((n_dev, Emax), np.int32),
        "boundary_gather": np.zeros((n_dev, B), np.int32),  # ids to export
        "boundary_mask": np.zeros((n_dev, B), np.float32),
    }
    for d in range(n_dev):
        own = np.where(labels == d)[0]
        out["node_feats"][d, : len(own)] = node_feats[own]
        out["targets"][d, : len(own)] = targets[own]
        out["node_mask"][d, : len(own)] = 1.0
        eid = np.where(labels[receivers] == d)[0]
        out["edge_feats"][d, : len(eid)] = edge_feats[eid]
        out["edge_mask"][d, : len(eid)] = 1.0
        out["receivers"][d, : len(eid)] = local_of[receivers[eid]]
        es = senders[eid]
        is_local = labels[es] == d
        slot = np.where(is_local, local_of[es], Nmax + bslot_of[es])
        out["senders_slot"][d, : len(eid)] = slot
        b = boundary_nodes[d]
        out["boundary_gather"][d, : len(b)] = local_of[b]
        out["boundary_mask"][d, : len(b)] = 1.0
    out["meta"] = {"B": B, "Nmax": Nmax, "Emax": Emax, "n_dev": n_dev}
    return out


class BoundaryExchange(torch.autograd.Function):
    """All-gather of each rank's exported (B, H) rows into a (W B, H)
    buffer, from ``all_reduce`` alone (which ``gloo`` also runs on CUDA
    tensors): each rank writes its rows into its own slot of a zero buffer
    and the buffers are summed; every slot has one nonzero contributor, so
    the sum is exact. The backward is the all-gather's transpose: the sum
    over ranks of the buffer's gradient (one more ``all_reduce``), of which
    the rank keeps its own slot. Each direction moves W times an
    all-gather's bytes."""

    @staticmethod
    def forward(ctx, exported, group):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        b = exported.shape[0]
        buf = exported.new_zeros((world * b, exported.shape[1]))
        buf[rank * b:(rank + 1) * b] = exported
        all_reduce(buf, group)
        ctx.group, ctx.rows = group, (rank * b, (rank + 1) * b)
        return buf

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        all_reduce(g, ctx.group)
        lo, hi = ctx.rows
        return g[lo:hi], None


def exchange(exported, group):
    """(B, H) rows of this rank -> (W B, H) rows of every rank, in rank
    order; differentiable (:class:`BoundaryExchange`)."""
    return BoundaryExchange.apply(exported, group)


def dmgn_apply_local(model: MeshGraphNet, shard: dict, group):
    """The distributed-MGN forward on this rank's shard (the tensors of one
    rank, from :func:`device_put_shards`).

    Each message-passing layer exchanges the boundary node features, builds
    messages from (local | exchanged) sender features and aggregates them
    locally. The gathers run through ``gather_rows`` over CSRs of their
    indices (masked edges and boundary slots left out: their gradient rows
    are zero), so their backward and the aggregation run the segment-sum
    kernel on the card. No layer is checkpointed, as in JAX's: a
    recomputed layer would run its exchange again in the backward pass.
    """
    nf, ef = shard["node_feats"], shard["edge_feats"]
    n_local = nf.shape[0]
    world = dist.get_world_size(group)
    n_bnd = shard["boundary_gather"].shape[0]
    send = shard["senders_slot"].long()
    recv = shard["receivers"].long()
    bnd = shard["boundary_gather"].long()
    em = shard["edge_mask"]
    send_csr = segops.prepare(send, n_local + world * n_bnd, em)
    recv_csr = segops.prepare(recv, n_local, em)
    bnd_csr = segops.prepare(bnd, n_local, shard["boundary_mask"])
    nm = shard["node_mask"][:, None]
    bm = shard["boundary_mask"][:, None]
    em = em[:, None]

    h = model.node_encoder(nf) * nm
    e = model.edge_encoder(ef) * em
    for pe, pn in zip(model.proc_edge, model.proc_node):
        # THE per-layer collective
        exported = segops.gather_rows(h, bnd, bnd_csr) * bm
        table = torch.cat([h, exchange(exported, group)], dim=0)
        msg_in = torch.cat([segops.gather_rows(table, send, send_csr),
                            segops.gather_rows(h, recv, recv_csr), e], dim=-1)
        e = (e + pe(msg_in)) * em
        agg = segops.segment_sum_prepared(recv_csr, e)
        h = (h + pn(torch.cat([h, agg], dim=-1))) * nm
    return model.decoder(h)


def make_dmgn_grad_fn(group, denom: float):
    """Returns ``f(model, shard) -> loss``: this rank's forward and backward
    (2L collectives), then one ``all_reduce`` of the loss and every
    gradient, as JAX's two ``psum``s; ``.grad`` holds the summed
    gradients."""

    def grad_fn(model: MeshGraphNet, shard: dict):
        for p in model.parameters():
            p.grad = None
        pred = dmgn_apply_local(model, shard, group)
        se = torch.sum(torch.square(pred - shard["targets"])
                       * shard["node_mask"][:, None])
        loss = se / denom
        loss.backward()
        return all_reduce_loss_and_grads(loss.detach(), model, group)
    return grad_fn


def device_put_shards(shards: dict, rank: int, device) -> dict:
    """Rank ``rank``'s shard of :func:`prepare_dmgn_shards` as tensors on
    ``device``."""
    dev = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(shards[k][rank])).to(dev)
            for k in SHARD_KEYS}
