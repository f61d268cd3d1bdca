"""Halo construction (paper SIII-A): make each partition self-contained.
Copied from the JAX package (``repro.core.halo``), with the point-shard
exports that sharded serving (``repro_torch.graphx.sharded``) plans with.

For an L-layer message-passing network, node ``i``'s output depends only on its
L-hop in-neighborhood. Define N_0 = owned nodes of a partition and
N_k = N_{k-1} ∪ senders(N_{k-1}). A partition carrying

* nodes  N_h            (owned first, then halo, h = halo hops), and
* edges  {(j→i) : i ∈ N_{h-1}}   (complete in-neighborhoods of N_{h-1})

reproduces the full graph's forward and backward computation exactly for the
owned nodes when h >= L: by induction, after layer l every node in N_{h-l}
holds exactly the value it would hold in the full graph. The loss is masked to
owned nodes, so summed partition gradients equal the full-graph gradient
(`tests/test_partition_equivalence.py` asserts this for the JAX package,
`tests/test_torch_train.py` for the port). With h < L the equivalence
breaks, as the paper states: the halo must be as deep as the number of MP
layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Partition:
    """One self-contained subgraph. Node order: owned nodes first, then halo
    (ordered by hop distance), so ``local id < n_owned`` <=> owned."""

    global_nodes: np.ndarray      # (n_local,) int64: local -> global node id
    n_owned: int
    senders: np.ndarray           # (e_local,) int32 local sender ids
    receivers: np.ndarray         # (e_local,) int32 local receiver ids
    edge_ids: np.ndarray          # (e_local,) int64 indices into global edges
    part_id: int = 0
    hop_of: np.ndarray | None = None  # (n_local,) int32 hop distance to owned

    @property
    def n_nodes(self) -> int:
        return int(self.global_nodes.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    def owned_mask(self) -> np.ndarray:
        m = np.zeros(self.n_nodes, bool)
        m[: self.n_owned] = True
        return m


def build_partition(senders: np.ndarray, receivers: np.ndarray,
                    labels: np.ndarray, part_id: int, halo_hops: int,
                    ) -> Partition:
    """Construct one partition with an ``halo_hops``-hop halo."""
    n_nodes = labels.shape[0]
    owned = np.where(labels == part_id)[0]
    # hop sets: N_0 = owned; N_k = N_{k-1} ∪ senders into N_{k-1}
    in_set = np.zeros(n_nodes, bool)
    in_set[owned] = True
    hop_of = np.full(n_nodes, -1, np.int32)
    hop_of[owned] = 0
    frontier = in_set.copy()
    for hop in range(1, halo_hops + 1):
        recv_in_frontier = frontier[receivers]
        new_nodes = senders[recv_in_frontier]
        newly = np.zeros(n_nodes, bool)
        newly[new_nodes] = True
        newly &= ~in_set
        in_set |= newly
        hop_of[newly] = hop
        frontier = in_set.copy()   # closure grows monotonically; re-expand all
    # node order: by hop, then id (owned = hop 0 first)
    local_nodes = np.where(in_set)[0]
    order = np.lexsort((local_nodes, hop_of[local_nodes]))
    global_nodes = local_nodes[order]
    g2l = np.full(n_nodes, -1, np.int64)
    g2l[global_nodes] = np.arange(len(global_nodes))
    # edges: receiver ∈ N_{h-1}
    keep_recv = in_set.copy()
    if halo_hops >= 1:
        keep_recv &= hop_of <= (halo_hops - 1)
    # senders of those edges are in N_h by construction when halo_hops >= 1;
    # for halo_hops == 0 keep only fully-internal edges.
    edge_mask = keep_recv[receivers] & in_set[senders]
    edge_ids = np.where(edge_mask)[0]
    return Partition(
        global_nodes=global_nodes.astype(np.int64),
        n_owned=int(len(owned)),
        senders=g2l[senders[edge_ids]].astype(np.int32),
        receivers=g2l[receivers[edge_ids]].astype(np.int32),
        edge_ids=edge_ids.astype(np.int64),
        part_id=part_id,
        hop_of=hop_of[global_nodes].astype(np.int32),
    )


def build_partitions(senders: np.ndarray, receivers: np.ndarray,
                     labels: np.ndarray, n_parts: int, halo_hops: int
                     ) -> List[Partition]:
    return [build_partition(senders, receivers, labels, p, halo_hops)
            for p in range(n_parts)]


def pad_partitions(parts: Sequence[Partition],
                   pad_nodes: int | None = None,
                   pad_edges: int | None = None) -> dict:
    """Pad all partitions to common (node, edge) counts and stack.

    Stacked so that every partition of every sample has one shape: the
    trainer walks a ``(P, max_nodes, ...)`` batch. Padding edges point at
    node 0 but carry ``edge_mask=0`` so their messages are zeroed before
    aggregation; padded nodes carry ``node_mask=0`` and never enter the loss.

    Returns dict of numpy arrays:
      nodes_global (P, Nmax) int64   (padding slots = 0, masked)
      node_mask    (P, Nmax) f32     1 for real nodes
      owned_mask   (P, Nmax) f32     1 for owned (loss) nodes
      senders/receivers (P, Emax) int32
      edge_mask    (P, Emax) f32
      edge_ids     (P, Emax) int64
    """
    P = len(parts)
    nmax = pad_nodes or max(p.n_nodes for p in parts)
    emax = pad_edges or max(p.n_edges for p in parts)
    out = {
        "nodes_global": np.zeros((P, nmax), np.int64),
        "node_mask": np.zeros((P, nmax), np.float32),
        "owned_mask": np.zeros((P, nmax), np.float32),
        "senders": np.zeros((P, emax), np.int32),
        "receivers": np.zeros((P, emax), np.int32),
        "edge_mask": np.zeros((P, emax), np.float32),
        "edge_ids": np.zeros((P, emax), np.int64),
    }
    for i, p in enumerate(parts):
        if p.n_nodes > nmax or p.n_edges > emax:
            raise ValueError("pad size smaller than partition")
        out["nodes_global"][i, : p.n_nodes] = p.global_nodes
        out["node_mask"][i, : p.n_nodes] = 1.0
        out["owned_mask"][i, : p.n_owned] = 1.0
        out["senders"][i, : p.n_edges] = p.senders
        out["receivers"][i, : p.n_edges] = p.receivers
        out["edge_mask"][i, : p.n_edges] = 1.0
        out["edge_ids"][i, : p.n_edges] = p.edge_ids
    return out


# hop value of padding slots in point-shard exports: larger than any real
# hop distance, so every "hop <= h" mask excludes padding
HOP_PAD = np.int32(2 ** 30)


def pack_point_shards(ids: Sequence[np.ndarray], hops: Sequence[np.ndarray],
                      owned: Sequence[np.ndarray],
                      pad_nodes: int | None = None) -> dict:
    """Pad per-shard (global id, hop, owned) membership lists and stack.

    The node-centric sibling of ``pad_partitions``: the sharded serving path
    (``repro_torch.graphx.sharded``) rebuilds each shard's graph on the
    device from its point buffer, so only membership is exported. Ids must
    be sorted ascending per shard (keeps nested multi-scale level membership
    a prefix of the local buffer).

    Returns dict of numpy arrays:
      global_ids (P, Nmax) int64   (padding slots = 0, masked)
      hop        (P, Nmax) int32   (padding slots = HOP_PAD)
      node_mask  (P, Nmax) bool    True for real member nodes
      owned      (P, Nmax) bool    True for owned nodes
      n_local    (P,)      int32   member count per shard
    """
    P = len(ids)
    nmax = pad_nodes or max(max((len(i) for i in ids), default=1), 1)
    out = {
        "global_ids": np.zeros((P, nmax), np.int64),
        "hop": np.full((P, nmax), HOP_PAD, np.int32),
        "node_mask": np.zeros((P, nmax), bool),
        "owned": np.zeros((P, nmax), bool),
        "n_local": np.zeros((P,), np.int32),
    }
    for i, (gid, hop, own) in enumerate(zip(ids, hops, owned)):
        m = len(gid)
        if m > nmax:
            raise ValueError(f"pad size {nmax} smaller than shard {i} "
                             f"({m} nodes)")
        out["global_ids"][i, :m] = gid
        out["hop"][i, :m] = hop
        out["node_mask"][i, :m] = True
        out["owned"][i, :m] = own
        out["n_local"][i] = m
    return out


def export_point_shards(parts: Sequence[Partition],
                        pad_nodes: int | None = None) -> dict:
    """Device-friendly padded export of partition *node membership*
    (see ``pack_point_shards`` for the layout), sorted by global id."""
    if not parts:
        raise ValueError("export_point_shards needs at least one partition")
    if any(p.hop_of is None for p in parts):
        raise ValueError("partitions lack hop_of (rebuild with "
                         "build_partition from this version)")
    ids, hops, owned = [], [], []
    for p in parts:
        order = np.argsort(p.global_nodes, kind="stable")
        ids.append(p.global_nodes[order])
        hops.append(p.hop_of[order])
        owned.append(p.hop_of[order] == 0)
    return pack_point_shards(ids, hops, owned, pad_nodes)


def halo_overhead(parts: Sequence[Partition], n_nodes: int) -> dict:
    """Paper SV-F: halo regions add memory/compute overhead; quantify it.

    Degenerate-safe: no partitions, empty partitions, and n_parts=1 (no halo
    at all) report finite numbers instead of raising.
    """
    total_local = sum(p.n_nodes for p in parts)
    return {
        "replication_factor": total_local / max(n_nodes, 1),
        "halo_fraction": 1.0 - sum(p.n_owned for p in parts) / max(total_local, 1),
        "max_nodes": max((p.n_nodes for p in parts), default=0),
        "max_edges": max((p.n_edges for p in parts), default=0),
    }
