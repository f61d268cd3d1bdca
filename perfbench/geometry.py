"""The traffic's geometry and the surface sampling, as frozen numpy copies.

The benchmark makes its cars itself: ``car_surface`` is the program's
parametric car (a superellipsoid with a cabin bump and a rear taper) with
the face loop written as array arithmetic, bit-equal to the loop. The
reference re-derives every served point cloud with ``sample_surface``, the
program's uniform area-weighted sampling, and every training target with
``surface_fields``, the analytic aerodynamic proxy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FLOW_DIR = np.array([1.0, 0.0, 0.0], np.float32)


@dataclass(frozen=True)
class CarParams:
    length: float
    width: float
    height: float
    cabin_height: float
    cabin_pos: float
    taper: float
    power: float


def sample_params(sample_id: int) -> CarParams:
    rng = np.random.default_rng(1000 + sample_id)
    return CarParams(
        length=float(rng.uniform(3.5, 5.2)),
        width=float(rng.uniform(1.6, 2.1)),
        height=float(rng.uniform(1.1, 1.6)),
        cabin_height=float(rng.uniform(0.25, 0.55)),
        cabin_pos=float(rng.uniform(-0.15, 0.25)),
        taper=float(rng.uniform(0.0, 0.5)),
        power=float(rng.uniform(2.2, 3.5)),
    )


def car_surface(params: CarParams, nu: int = 64, nv: int = 32):
    """Closed triangulated surface: (vertices (nu nv, 3) f32, faces
    (2 nu (nv - 1), 3) i64)."""
    u = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = params.power

    def spow(x, e):
        return np.sign(x) * np.abs(x) ** e

    x = spow(np.sin(vv), 2 / p) * spow(np.cos(uu), 2 / p)
    y = spow(np.sin(vv), 2 / p) * spow(np.sin(uu), 2 / p)
    z = spow(np.cos(vv), 2 / p)
    x = x * params.length / 2
    y = y * params.width / 2
    z = z * params.height / 2
    cab = params.cabin_height * np.exp(
        -((x / params.length - params.cabin_pos) / 0.18) ** 2) \
        * np.clip(z, 0, None) / (params.height / 2)
    z = z + cab
    taper = 1.0 - params.taper * np.clip(x / (params.length / 2), 0, 1) ** 2
    y = y * taper
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv - 1), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = b + 1
    d = a + 1
    faces = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                     axis=2).reshape(-1, 3)
    return verts, faces.astype(np.int64)


def triangle_areas(vertices, faces):
    a, b, c = (vertices[faces[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def triangle_normals(vertices, faces):
    a, b, c = (vertices[faces[:, i]] for i in range(3))
    n = np.cross(b - a, c - a)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def sample_surface(vertices, faces, n_points: int, rng: np.random.Generator):
    """Uniform point cloud on a triangle surface, probability proportional
    to area: (points (n, 3) f32, normals (n, 3) f32)."""
    areas = triangle_areas(vertices, faces)
    p = areas / areas.sum()
    tri = rng.choice(len(faces), size=n_points, p=p)
    u = rng.random((n_points, 1))
    v = rng.random((n_points, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    a = vertices[faces[tri, 0]]
    b = vertices[faces[tri, 1]]
    c = vertices[faces[tri, 2]]
    pts = a + u * (b - a) + v * (c - a)
    normals = triangle_normals(vertices, faces)[tri]
    return pts.astype(np.float32), normals.astype(np.float32)


def surface_fields(points, normals, params: CarParams):
    """Analytic targets (N, 4): pressure coefficient and wall shear."""
    n_dot = normals @ FLOW_DIR
    x_rel = points[:, 0] / (params.length / 2)
    cp = 1.0 - 2.25 * (1.0 - n_dot ** 2)
    wake = -0.35 * np.exp(-((x_rel - 1.0) / 0.35) ** 2)
    cp = cp + wake + 0.2 * np.tanh(2 * points[:, 2] / params.height)
    ripple = 0.25 * np.sin(4 * np.pi * points[:, 0]) * \
        np.sin(3 * np.pi * points[:, 1]) * (1.0 - n_dot ** 2)
    cp = cp + ripple
    t = FLOW_DIR[None, :] - n_dot[:, None] * normals
    tn = np.linalg.norm(t, axis=1, keepdims=True)
    t = t / np.maximum(tn, 1e-6)
    tau_mag = 0.05 * (1.0 - n_dot ** 2) ** 0.5 * (1.0 + 0.5 * np.tanh(-x_rel))
    tau = tau_mag[:, None] * t
    return np.concatenate([cp[:, None], tau], axis=1).astype(np.float32)
