"""Graph container of the host graph construction (numpy), copied from the
JAX package (``repro.core.graph``).

Edges are directed: message flows ``senders[e] -> receivers[e]``. k-NN
construction emits both directions so message passing is symmetric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Graph:
    positions: np.ndarray            # (N, 3) float32 node coordinates
    senders: np.ndarray              # (E,) int32
    receivers: np.ndarray            # (E,) int32
    node_feats: Optional[np.ndarray] = None   # (N, F)
    edge_feats: Optional[np.ndarray] = None   # (E, K)
    node_targets: Optional[np.ndarray] = None  # (N, T)
    normals: Optional[np.ndarray] = None       # (N, 3)
    level_of_edge: Optional[np.ndarray] = None  # (E,) multi-scale level id

    @property
    def n_nodes(self) -> int:
        return int(self.positions.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    def validate(self) -> None:
        assert self.senders.shape == self.receivers.shape
        assert self.senders.min(initial=0) >= 0
        assert self.receivers.min(initial=0) >= 0
        if self.n_edges:
            assert int(self.senders.max()) < self.n_nodes
            assert int(self.receivers.max()) < self.n_nodes
        if self.edge_feats is not None:
            assert self.edge_feats.shape[0] == self.n_edges
        if self.node_feats is not None:
            assert self.node_feats.shape[0] == self.n_nodes


def relative_edge_features(positions: np.ndarray, senders: np.ndarray,
                           receivers: np.ndarray) -> np.ndarray:
    """MeshGraphNet edge features: relative position vector + its norm."""
    rel = positions[senders] - positions[receivers]
    dist = np.linalg.norm(rel, axis=-1, keepdims=True)
    return np.concatenate([rel, dist], axis=-1).astype(np.float32)


def in_degrees(receivers: np.ndarray, n_nodes: int) -> np.ndarray:
    return np.bincount(receivers, minlength=n_nodes)
