"""Graph partitioning (paper SIII-A), copied from the JAX package
(``repro.core.partitioning``).

The paper uses METIS; METIS is not available offline, so we provide a
METIS-like partitioner with the same interface and objectives:

* balance — near-equal node counts per partition (paper: "making the number of
  nodes and edges in each partition similar ... better load balancing");
* low edge cut — minimizes halo size and padding waste.

Two stages:
1. recursive coordinate bisection (RCB) on node positions — geometric graphs
   (point clouds) partition extremely well spatially;
2. greedy Kernighan–Lin-style boundary refinement on the actual edges, moving
   boundary nodes to the neighboring partition when it reduces edge cut
   without violating the balance constraint.

A BFS-growing fallback handles graphs without coordinates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def edge_cut(senders: np.ndarray, receivers: np.ndarray,
             labels: np.ndarray) -> int:
    """Number of edges whose endpoints lie in different partitions."""
    return int(np.sum(labels[senders] != labels[receivers]))


def partition_rcb(positions: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: split along the widest axis so that
    child part counts (hence node counts) stay proportional. Handles any
    ``n_parts`` (not just powers of two)."""
    n = len(positions)
    labels = np.zeros(n, np.int32)

    def rec(idx: np.ndarray, parts: int, first_label: int):
        if parts == 1:
            labels[idx] = first_label
            return
        p_left = parts // 2
        frac = p_left / parts
        pts = positions[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, axis], kind="stable")
        n_left = int(round(len(idx) * frac))
        n_left = min(max(n_left, 1), len(idx) - 1)
        rec(idx[order[:n_left]], p_left, first_label)
        rec(idx[order[n_left:]], parts - p_left, first_label + p_left)

    rec(np.arange(n), n_parts, 0)
    return labels


def partition_bfs(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
                  n_parts: int, seed: int = 0) -> np.ndarray:
    """Topology-only fallback: grow partitions by BFS from spread-out seeds."""
    rng = np.random.default_rng(seed)
    target = int(np.ceil(n_nodes / n_parts))
    # adjacency (undirected view)
    order = np.argsort(senders, kind="stable")
    adj_dst = receivers[order]
    adj_ptr = np.searchsorted(senders[order], np.arange(n_nodes + 1))
    labels = np.full(n_nodes, -1, np.int32)
    frontier_sets = []
    seeds = rng.choice(n_nodes, size=min(n_parts, n_nodes), replace=False)
    for p, s in enumerate(seeds):
        labels[s] = p
        frontier_sets.append([int(s)])
    counts = np.bincount(labels[labels >= 0], minlength=n_parts)
    active = True
    while active:
        active = False
        for p in range(n_parts):
            if counts[p] >= target or not frontier_sets[p]:
                continue
            new_frontier = []
            for u in frontier_sets[p]:
                for v in adj_dst[adj_ptr[u]:adj_ptr[u + 1]]:
                    if labels[v] < 0 and counts[p] < target:
                        labels[v] = p
                        counts[p] += 1
                        new_frontier.append(int(v))
            frontier_sets[p] = new_frontier
            active = active or bool(new_frontier)
    # orphans (disconnected): assign to smallest parts
    for u in np.where(labels < 0)[0]:
        p = int(np.argmin(counts))
        labels[u] = p
        counts[p] += 1
    return labels


def refine_greedy(senders: np.ndarray, receivers: np.ndarray,
                  labels: np.ndarray, n_parts: int,
                  rounds: int = 3, balance_tol: float = 0.05) -> np.ndarray:
    """KL/FM-style refinement: move boundary nodes to the neighbor partition
    with the largest gain (cut reduction), respecting a node-balance budget."""
    labels = labels.copy()
    n = labels.shape[0]
    max_size = int(np.ceil(n / n_parts * (1.0 + balance_tol)))
    min_size = int(np.floor(n / n_parts * (1.0 - balance_tol)))
    for _ in range(rounds):
        counts = np.bincount(labels, minlength=n_parts)
        # per (node, neighbor-part) edge tallies, undirected
        u = np.concatenate([senders, receivers])
        v = np.concatenate([receivers, senders])
        lu, lv = labels[u], labels[v]
        boundary = np.unique(u[lu != lv])
        if len(boundary) == 0:
            break
        moved = 0
        # count node->part edges via sparse accumulation
        key = u.astype(np.int64) * n_parts + lv
        cnt = np.bincount(key, minlength=n * n_parts)
        for node in boundary:
            row = cnt[node * n_parts:(node + 1) * n_parts]
            cur = labels[node]
            best = int(np.argmax(row))
            gain = int(row[best]) - int(row[cur])
            if best != cur and gain > 0 and counts[best] < max_size \
                    and counts[cur] > min_size:
                labels[node] = best
                counts[cur] -= 1
                counts[best] += 1
                moved += 1
        if moved == 0:
            break
    return labels


def partition(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
              n_parts: int, positions: Optional[np.ndarray] = None,
              refine_rounds: int = 3, seed: int = 0) -> np.ndarray:
    """METIS-like entry point: balanced, low-edge-cut node partition labels."""
    if n_parts <= 1:
        return np.zeros(n_nodes, np.int32)
    if positions is not None:
        labels = partition_rcb(np.asarray(positions, np.float64), n_parts)
    else:
        labels = partition_bfs(senders, receivers, n_nodes, n_parts, seed)
    if refine_rounds > 0 and len(senders):
        labels = refine_greedy(senders, receivers, labels, n_parts,
                               rounds=refine_rounds)
    return labels


def balance_stats(labels: np.ndarray, n_parts: int) -> dict:
    """Node-count balance of a labeling.

    Degenerate-safe: n_parts=1 reports imbalance 1.0; empty labelings and
    empty partitions report finite numbers instead of dividing by zero.
    """
    labels = np.asarray(labels)
    n_parts = max(int(n_parts), 1)
    counts = np.bincount(labels, minlength=n_parts).astype(np.float64) \
        if labels.size else np.zeros(n_parts)
    mean = counts.mean()
    return {
        "min": int(counts.min()),
        "max": int(counts.max()),
        "imbalance": float(counts.max() / mean) if mean > 0 else 1.0,
    }
