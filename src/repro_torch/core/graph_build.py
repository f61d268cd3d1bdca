"""Surface sampling from tessellated geometry (numpy), copied from the JAX
package so the port samples the same clouds from the same generator."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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
