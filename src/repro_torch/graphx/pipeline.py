"""End-to-end inference on tensors: padded point cloud -> predicted fields.

Port of ``repro.graphx.pipeline``. Where the JAX package compiles one
program per bucket, this runs eagerly under ``torch.no_grad``: hash-grid
kNN at every level (the kNN kernel), the multi-scale edge union,
featurization, and the MeshGraphNet forward (the segment-sum kernel in every
layer). The device is the inputs' device. The model is passed to each call,
as the JAX functions take ``params``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.graphx import features as fx
from repro_torch.graphx.multiscale import MultiscaleSpec, multiscale_edges

Stats = Optional[Tuple[np.ndarray, np.ndarray]]


def _stats_on(stats: Stats, device):
    if stats is None:
        return None
    return (torch.as_tensor(np.asarray(stats[0], np.float32), device=device),
            torch.as_tensor(np.asarray(stats[1], np.float32), device=device))


def make_featurizer(cfg: GNNConfig, *, norm_in: Stats = None):
    """``featurize(points, normals, senders, receivers, emask)`` -> graph
    dict ``{node_feats, edge_feats, senders, receivers, emask}``."""

    @torch.no_grad()
    def featurize(points, normals, senders, receivers, emask):
        points = points.float()
        feats = fx.node_input_features(points, normals, cfg.fourier_freqs)
        stats = _stats_on(norm_in, points.device)
        if stats is not None:
            feats = (feats - stats[0]) / stats[1]
        edge_feats = fx.relative_edge_features(points, senders, receivers,
                                               emask)
        return {"node_feats": feats, "edge_feats": edge_feats,
                "senders": senders, "receivers": receivers, "emask": emask}

    return featurize


def make_step_fn(cfg: GNNConfig, *, norm_out: Stats = None):
    """``step(model, graph, state)`` -> next state (N, node_out): model
    forward + output denorm + state integration."""

    @torch.no_grad()
    def step(model, graph, state):
        nf = graph["node_feats"]
        return model.step(nf, graph["edge_feats"], graph["senders"],
                          graph["receivers"], state,
                          edge_mask=graph["emask"].to(nf.dtype),
                          out_stats=_stats_on(norm_out, nf.device))

    return step


def make_graph_forward(cfg: GNNConfig, *, norm_in: Stats = None,
                       norm_out: Stats = None):
    """``forward(model, points, normals, senders, receivers, emask)`` ->
    (N, node_out): featurize, then one physics step from a zero state (with
    the default ``'direct'`` integrator this is the plain forward pass)."""
    featurize = make_featurizer(cfg, norm_in=norm_in)
    step = make_step_fn(cfg, norm_out=norm_out)

    @torch.no_grad()
    def forward(model, points, normals, senders, receivers, emask):
        graph = featurize(points, normals, senders, receivers, emask)
        nf = graph["node_feats"]
        state0 = nf.new_zeros(nf.shape[:-1] + (cfg.node_out,))
        return step(model, graph, state0)

    return forward


def make_infer_fn(cfg: GNNConfig, ms: MultiscaleSpec, *,
                  norm_in: Stats = None, norm_out: Stats = None):
    """``infer(model, points, normals, n_valid)`` -> (N, node_out).

    points/normals: (ms.n_points, 3) padded tensors; n_valid: count of real
    points (a prefix). ``norm_in``/``norm_out`` are optional (mean, std)
    pairs for input encoding and output decoding.
    """
    forward = make_graph_forward(cfg, norm_in=norm_in, norm_out=norm_out)

    @torch.no_grad()
    def infer(model, points, normals, n_valid):
        points = points.float()
        senders, receivers, emask = multiscale_edges(points, n_valid, ms)
        return forward(model, points, normals, senders, receivers, emask)

    return infer


def make_batched_infer_fn(cfg: GNNConfig, ms: MultiscaleSpec, **kw):
    """``(model, (B, N, 3), (B, N, 3), (B,)) -> (B, N, out)``: the JAX
    package's vmap, written as a loop over the rows (one graph at a time
    keeps a full-width row's edge activations the only large buffer)."""
    infer = make_infer_fn(cfg, ms, **kw)

    @torch.no_grad()
    def batched(model, points, normals, n_valid):
        return torch.stack([infer(model, points[i], normals[i],
                                  int(n_valid[i]))
                            for i in range(points.shape[0])])

    return batched
