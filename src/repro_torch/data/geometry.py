"""Synthetic parametric car geometry and its analytic aerodynamic proxy
field (numpy), copied from the JAX package (``repro.data.geometry``).

The demo traffic, the server's calibration reference and the training data
must be bit-equal to the JAX package's, so this is a verbatim copy of
``CarParams``, ``sample_params``, ``car_surface``, ``FLOW_DIR`` and
``surface_fields``, and of X-UNet3D's volume proxy ``volume_fields`` and
``signed_distance_box``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FLOW_DIR = np.array([1.0, 0.0, 0.0], np.float32)   # +x airflow


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
    """Triangulated closed surface. Returns (vertices (N,3), faces (F,3))."""
    u = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = params.power

    def spow(x, e):
        return np.sign(x) * np.abs(x) ** e

    # superellipsoid base
    x = spow(np.sin(vv), 2 / p) * spow(np.cos(uu), 2 / p)
    y = spow(np.sin(vv), 2 / p) * spow(np.sin(uu), 2 / p)
    z = spow(np.cos(vv), 2 / p)
    # scale to car-like proportions
    x = x * params.length / 2
    y = y * params.width / 2
    z = z * params.height / 2
    # cabin bump on the top surface
    cab = params.cabin_height * np.exp(
        -((x / params.length - params.cabin_pos) / 0.18) ** 2) \
        * np.clip(z, 0, None) / (params.height / 2)
    z = z + cab
    # rear taper
    taper = 1.0 - params.taper * np.clip(x / (params.length / 2), 0, 1) ** 2
    y = y * taper
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    faces = []

    def vid(i, j):
        return (i % nu) * nv + j
    for i in range(nu):
        for j in range(nv - 1):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return verts, np.asarray(faces, np.int64)


def surface_fields(points: np.ndarray, normals: np.ndarray,
                   params: CarParams) -> np.ndarray:
    """Analytic targets (N, 4): [pressure_coeff, tau_x, tau_y, tau_z].

    cp follows the potential-flow stagnation pattern 1 - (3/2 sin(theta))^2
    style dependence on the angle between the surface normal and the flow,
    with a geometry-dependent wake deficit; shear is tangential, strongest
    where the flow grazes the surface.
    """
    n_dot = normals @ FLOW_DIR                      # cos(angle to flow)
    x_rel = points[:, 0] / (params.length / 2)
    cp = 1.0 - 2.25 * (1.0 - n_dot ** 2)            # stagnation -> suction
    wake = -0.35 * np.exp(-((x_rel - 1.0) / 0.35) ** 2)   # base pressure
    cp = cp + wake + 0.2 * np.tanh(2 * points[:, 2] / params.height)
    # high-frequency content (separation ripples / panel-scale structure):
    # real CFD fields carry this; it is what the paper's Fourier features
    # and multi-level graphs exist to capture (Fig. 9)
    ripple = 0.25 * np.sin(4 * np.pi * points[:, 0]) * \
        np.sin(3 * np.pi * points[:, 1]) * (1.0 - n_dot ** 2)
    cp = cp + ripple
    # tangential flow direction: project flow onto tangent plane
    t = FLOW_DIR[None, :] - n_dot[:, None] * normals
    tn = np.linalg.norm(t, axis=1, keepdims=True)
    t = t / np.maximum(tn, 1e-6)
    tau_mag = 0.05 * (1.0 - n_dot ** 2) ** 0.5 * (1.0 + 0.5 * np.tanh(-x_rel))
    tau = tau_mag[:, None] * t
    return np.concatenate([cp[:, None], tau], axis=1).astype(np.float32)


def volume_fields(points: np.ndarray, params: CarParams) -> np.ndarray:
    """Analytic volumetric proxy (N, 4): [u, v, w, p] around the body —
    free stream + dipole-like perturbation + wake deficit (for X-UNet3D)."""
    r = np.linalg.norm(points / np.array(
        [params.length / 2, params.width / 2, params.height / 2]), axis=1)
    r = np.maximum(r, 0.7)
    pert = 1.0 / r ** 3
    u = 1.0 - 0.8 * pert
    xw = points[:, 0] / (params.length / 2)
    wake = np.exp(-np.clip(xw - 1.0, 0, None) / 1.5) * \
        np.exp(-(points[:, 1] ** 2 + points[:, 2] ** 2) / 0.4) * (xw > 0.8)
    u = u - 0.5 * wake
    v = 0.3 * pert * points[:, 1]
    w = 0.3 * pert * points[:, 2]
    p = 0.5 * (1.0 - u ** 2 - v ** 2 - w ** 2)
    return np.stack([u, v, w, p], axis=1).astype(np.float32)


def signed_distance_box(points: np.ndarray, params: CarParams) -> np.ndarray:
    """Cheap SDF proxy to the car body (ellipsoidal distance)."""
    q = points / np.array([params.length / 2, params.width / 2,
                           params.height / 2])
    return (np.linalg.norm(q, axis=1) - 1.0).astype(np.float32)
