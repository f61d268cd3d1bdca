"""Graph construction from tessellated geometry on the host (numpy and
scipy), copied from the JAX package (``repro.core.graph_build``): surface
and volume sampling (the port samples the same clouds from the same
generator), vertex normals, k-NN and radius edges by cKDTree, a whole
:class:`Graph` (:func:`build_graph`) and the node input features of the
training path."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from repro_torch.core.graph import Graph, relative_edge_features


def triangle_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = (vertices[faces[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def triangle_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = (vertices[faces[:, i]] for i in range(3))
    n = np.cross(b - a, c - a)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n_points: int,
                   rng: np.random.Generator,
                   curvature_weight: float = 0.0,
                   curvature: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform (or curvature-weighted) point cloud on a triangle surface.

    Returns (points (n,3), normals (n,3)); sampling probability is
    proportional to area * (1 + w * curvature).
    """
    areas = triangle_areas(vertices, faces)
    w = areas.copy()
    if curvature_weight > 0.0 and curvature is not None:
        w = w * (1.0 + curvature_weight * curvature)
    p = w / w.sum()
    tri_idx = rng.choice(len(faces), size=n_points, p=p)
    # uniform barycentric sampling
    u = rng.random((n_points, 1))
    v = rng.random((n_points, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    a = vertices[faces[tri_idx, 0]]
    b = vertices[faces[tri_idx, 1]]
    c = vertices[faces[tri_idx, 2]]
    pts = a + u * (b - a) + v * (c - a)
    normals = triangle_normals(vertices, faces)[tri_idx]
    return pts.astype(np.float32), normals.astype(np.float32)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex normals: area-weighted average of incident face normals.

    The unnormalized face cross product *is* the area weighting, so one
    scatter-add of it per face corner gives the standard smooth normal.
    """
    a, b, c = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(b - a, c - a)                      # |fn| = 2 * area
    vn = np.zeros_like(vertices, dtype=np.float64)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    return (vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True),
                            1e-12)).astype(np.float32)


def sample_volume(vertices: np.ndarray, n_points: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Uniform point cloud inside the axis-aligned bounding box of a geometry
    (volume-mode construction, paper SIII-B)."""
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    return (lo + rng.random((n_points, 3)) * (hi - lo)).astype(np.float32)


def knn_edges(points: np.ndarray, k: int, *,
              bidirectional: bool = True,
              max_radius: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Connect each point to its k nearest neighbors (excluding itself).

    Returns directed (senders, receivers): edge j->i for each neighbor j of i.
    With ``bidirectional`` the reverse edges are added and duplicates removed,
    so in/out neighborhoods are symmetric (the paper connects k-NN and passes
    messages both ways).
    """
    n = len(points)
    kq = min(k + 1, n)
    tree = cKDTree(points)
    dist, idx = tree.query(points, k=kq)
    if kq == 1:
        idx = idx[:, None]
        dist = dist[:, None]
    receivers = np.repeat(np.arange(n, dtype=np.int64), idx.shape[1])
    senders = idx.reshape(-1).astype(np.int64)
    keep = senders != receivers
    if max_radius is not None:
        keep &= dist.reshape(-1) <= max_radius
    senders, receivers = senders[keep], receivers[keep]
    # per-receiver cap at k (self-exclusion may leave k valid already)
    order = np.argsort(receivers, kind="stable")
    senders, receivers = senders[order], receivers[order]
    pos_in_rec = np.arange(len(receivers)) - np.searchsorted(receivers, receivers, side="left")
    keep = pos_in_rec < k
    senders, receivers = senders[keep], receivers[keep]
    if bidirectional:
        s = np.concatenate([senders, receivers])
        r = np.concatenate([receivers, senders])
        uniq = np.unique(np.stack([s, r], axis=1), axis=0)
        senders, receivers = uniq[:, 0], uniq[:, 1]
    return senders.astype(np.int32), receivers.astype(np.int32)


def radius_edges(points: np.ndarray, radius: float,
                 max_degree: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Alternative connectivity (paper SVII future work): connect all pairs
    within ``radius``, capped at ``max_degree`` per receiver."""
    tree = cKDTree(points)
    pairs = tree.query_pairs(radius, output_type="ndarray")
    if len(pairs) == 0:
        return (np.zeros((0,), np.int32),) * 2
    s = np.concatenate([pairs[:, 0], pairs[:, 1]])
    r = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    pos = np.arange(len(r)) - np.searchsorted(r, r, side="left")
    keep = pos < max_degree
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


def build_graph(points: np.ndarray, k: int,
                normals: Optional[np.ndarray] = None) -> Graph:
    """The bidirectional k-NN :class:`Graph` of ``points`` with its
    relative-position edge features, validated."""
    senders, receivers = knn_edges(points, k)
    g = Graph(positions=points, senders=senders, receivers=receivers,
              normals=normals)
    g.edge_feats = relative_edge_features(points, senders, receivers)
    g.validate()
    return g


def fourier_features(x: np.ndarray, freqs) -> np.ndarray:
    """sin/cos positional features (paper SV-A, frequencies 2pi,4pi,8pi).
    Empty ``freqs`` (the Fig-9 no-Fourier ablation) yields a 0-wide array."""
    feats = [np.zeros((*x.shape[:-1], 0), np.float32)]
    for f in freqs:
        feats.append(np.sin(np.pi * f * x))
        feats.append(np.cos(np.pi * f * x))
    return np.concatenate(feats, axis=-1).astype(np.float32)


def node_input_features(points: np.ndarray, normals: Optional[np.ndarray],
                        freqs, include_positions: bool = True) -> np.ndarray:
    """Paper SV-A inputs: 3D positions, surface normals, Fourier features.

    3 + 3 + 3*len(freqs)*2 features; with the paper's 3 frequencies: 24.
    """
    parts = []
    if include_positions:
        parts.append(points.astype(np.float32))
    if normals is not None:
        parts.append(normals.astype(np.float32))
    parts.append(fourier_features(points, freqs))
    return np.concatenate(parts, axis=-1)
