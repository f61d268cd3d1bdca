"""Multi-scale graph generation (paper SIII-C), copied from the JAX package
(``repro.core.multiscale``).

Nested point clouds: the level-``i`` point cloud is a strict subset (prefix) of
level ``i+1``. Each level gets its own k-NN connectivity computed *within that
level's points only* — coarse levels therefore produce long-range edges. The
final graph is the finest point cloud with the union of all levels' edges,
giving the model cheap long-range message paths.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph, relative_edge_features
from repro_torch.core.graph_build import knn_edges, sample_surface


def nested_point_clouds(vertices: np.ndarray, faces: np.ndarray,
                        level_sizes: Sequence[int],
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample the finest cloud once; coarser levels are prefixes.

    Sampling ``n_finest`` points i.i.d. uniformly and taking the first ``n_l``
    as level ``l`` yields a uniform point cloud at every level while enforcing
    the paper's superset property exactly.

    Returns (points (n_finest, 3), normals (n_finest, 3)).
    """
    sizes = sorted(level_sizes)
    if sizes != list(level_sizes):
        raise ValueError("level_sizes must be increasing (coarse -> fine)")
    return sample_surface(vertices, faces, sizes[-1], rng)


def multiscale_edges(points: np.ndarray, level_sizes: Sequence[int], k: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k-NN edges per level over the nested prefixes; union with level ids.

    Duplicate edges appearing at several levels are kept once, tagged with the
    coarsest level that produced them (coarse edges are the long-range ones).
    """
    all_s, all_r, all_l = [], [], []
    for lvl, n in enumerate(sorted(level_sizes)):
        s, r = knn_edges(points[:n], k)
        all_s.append(s.astype(np.int64))
        all_r.append(r.astype(np.int64))
        all_l.append(np.full(len(s), lvl, np.int32))
    s = np.concatenate(all_s)
    r = np.concatenate(all_r)
    l = np.concatenate(all_l)
    # dedupe, keeping the first (coarsest) occurrence
    key = s * (points.shape[0] + 1) + r
    _, first = np.unique(key, return_index=True)
    first.sort()
    return s[first].astype(np.int32), r[first].astype(np.int32), l[first]


def build_multiscale_graph(vertices: np.ndarray, faces: np.ndarray,
                           level_sizes: Sequence[int], k: int,
                           rng: np.random.Generator) -> Graph:
    """The paper's tessellated geometry to multi-scale graph, on the host:
    :func:`nested_point_clouds` of the triangle surface, then
    :func:`multiscale_edges`, with relative edge features."""
    points, normals = nested_point_clouds(vertices, faces, level_sizes, rng)
    return build_multiscale_from_points(points, level_sizes, k,
                                        normals=normals)


def build_multiscale_from_points(points: np.ndarray,
                                 level_sizes: Sequence[int], k: int,
                                 normals: Optional[np.ndarray] = None) -> Graph:
    """Multi-scale graph over an already-sampled (nested-ordered) point cloud."""
    s, r, lvl = multiscale_edges(points, level_sizes, k)
    g = Graph(positions=points, senders=s, receivers=r, normals=normals,
              level_of_edge=lvl)
    g.edge_feats = relative_edge_features(points, s, r)
    g.validate()
    return g
