"""End-to-end inference on tensors: padded point cloud -> predicted fields.

Port of ``repro.graphx.pipeline``. Where the JAX package compiles one
program per bucket, this runs eagerly under ``torch.no_grad``: hash-grid
kNN at every level (the kNN kernel), the multi-scale edge union,
featurization, and the MeshGraphNet forward (the segment-sum kernel in every
layer). The device is the inputs' device. The model is passed to each call,
as the JAX functions take ``params``. Under a running ``torch.profiler``
the stages are spans (``telemetry.span``): ``knn`` once per level,
``compact`` (batched), ``features``, then the model's ``encoder``,
``processor`` and ``decoder``; host ranges around asynchronous launches,
they time the enqueue, not the device.

Serving (:func:`make_infer_fn`, :func:`make_batched_infer_fn`) runs the
model over the valid edges only: :func:`compact_edges` drops the union's
masked slots (about half of them: mutual-kNN duplicates and edges a
coarser level already has) before featurization, keeping the slot order,
so every receiver sums the same messages in the same order as over the
padded union, and the model runs with no edge mask.

The rollout halves split that pipeline for the transient-rollout engine
(``launch.rollout``): :func:`make_prefill_fn` builds the graph and its
step-invariant features once per geometry, :func:`make_generate_fn`
advances a slot table's active lanes, one graph at a time.
:func:`device_multiscale_edges` is the same edge build for the training
data path (``graph_source='graphx'``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve
from repro_torch.graphx import features as fx
from repro_torch.graphx import hashgrid
from repro_torch.graphx.multiscale import MultiscaleSpec, multiscale_edges
from repro_torch.telemetry import span

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
    forward + output denorm + state integration, by ``cfg``'s
    ``rollout_integrator`` and ``rollout_state_feats`` (not the model's)."""

    @torch.no_grad()
    def step(model, graph, state):
        nf, em = graph["node_feats"], graph["emask"]
        return model.step(nf, graph["edge_feats"], graph["senders"],
                          graph["receivers"], state,
                          edge_mask=None if em is None else em.to(nf.dtype),
                          out_stats=_stats_on(norm_out, nf.device), cfg=cfg)

    return step


def make_graph_forward(cfg: GNNConfig, *, norm_in: Stats = None,
                       norm_out: Stats = None):
    """``forward(model, points, normals, senders, receivers, emask)`` ->
    (N, node_out): featurize, then one physics step from a zero state (with
    the default ``'direct'`` integrator this is the plain forward pass).
    ``emask`` None: every edge is real (:func:`compact_edges`)."""
    featurize = make_featurizer(cfg, norm_in=norm_in)
    step = make_step_fn(cfg, norm_out=norm_out)

    @torch.no_grad()
    def forward(model, points, normals, senders, receivers, emask):
        with span("features"):
            graph = featurize(points, normals, senders, receivers, emask)
        nf = graph["node_feats"]
        state0 = nf.new_zeros(nf.shape[:-1] + (cfg.node_out,))
        return step(model, graph, state0)

    return forward


def compact_edges(senders, receivers, emask, n_edges: int):
    """``(senders[emask], receivers[emask])``: the valid edges of a
    fixed-shape union, in ascending slot order (``torch.nonzero``'s), so
    that each receiver's CSR run lists its edges in the union's order.
    ``n_edges`` is the count of ``emask``'s True slots, read beforehand:
    with it the compaction waits for nothing (``torch.nonzero_static``).
    """
    idx = torch.nonzero_static(emask, size=n_edges).squeeze(1)
    return senders[idx], receivers[idx]


def make_infer_fn(cfg: GNNConfig, ms: MultiscaleSpec, *,
                  norm_in: Stats = None, norm_out: Stats = None):
    """``infer(model, points, normals, n_valid)`` -> (N, node_out).

    points/normals: (ms.n_points, 3) padded tensors; n_valid: count of real
    points (a prefix). ``norm_in``/``norm_out`` are optional (mean, std)
    pairs for input encoding and output decoding. The model runs over the
    valid edges only (:func:`compact_edges`, after one wait for the
    device: the count of them).
    """
    forward = make_graph_forward(cfg, norm_in=norm_in, norm_out=norm_out)

    @torch.no_grad()
    def infer(model, points, normals, n_valid):
        points = points.float()
        senders, receivers, emask = multiscale_edges(points, n_valid, ms)
        senders, receivers = compact_edges(senders, receivers, emask,
                                           int(emask.sum()))
        return forward(model, points, normals, senders, receivers, None)

    return infer


def make_batched_infer_fn(cfg: GNNConfig, ms: MultiscaleSpec, *,
                          on_edges=None, **kw):
    """``(model, (B, N, 3), (B, N, 3), (B,)) -> (B, N, out)``: the JAX
    package's vmap, written as a loop over the rows (one graph at a time
    keeps a full-width row's edge activations the only large buffer).

    Every row's graph is built and compacted (:func:`compact_edges`) before
    the first forward is enqueued: the rows' valid-edge counts are read in
    one wait for the device, span ``compact``, where a wait per row would
    also wait for the row before it. ``on_edges``, if given, is called with
    those counts, a list of host integers, one a row, each out of
    ``ms.n_edges`` slots.
    """
    forward = make_graph_forward(cfg, **kw)

    @torch.no_grad()
    def batched(model, points, normals, n_valid):
        points = points.float()
        graphs = [multiscale_edges(points[i], int(n_valid[i]), ms)
                  for i in range(points.shape[0])]
        with span("compact"):
            counts = torch.stack([em.sum() for _, _, em in graphs]).tolist()
            edges = [compact_edges(s, r, em, c)
                     for (s, r, em), c in zip(graphs, counts)]
        if on_edges is not None:
            on_edges(counts)
        return torch.stack([forward(model, points[i], normals[i], s, r, None)
                            for i, (s, r) in enumerate(edges)])

    return batched


def make_edges_fn(ms: MultiscaleSpec):
    """Graph construction alone: ``edges(points, n_valid) -> (senders,
    receivers, emask)`` with the fixed-shape layout of ``multiscale_edges``.
    Eager: the JAX version's ``jit`` and its memoization per spec have
    nothing to compile here."""

    @torch.no_grad()
    def edges(points, n_valid):
        return multiscale_edges(points.float(), n_valid, ms)

    return edges


def device_multiscale_edges(points: np.ndarray, level_sizes, k: int, *,
                            device=None):
    """One-shot edge build for a host-resident nested cloud, on ``device``
    (default: the card).

    Calibrates the per-level grids on this cloud, on the host (so the
    hash-grid kNN finds the exact cKDTree neighbours), runs the fixed-shape
    union once on the device and compacts it to numpy ``(senders,
    receivers, level_of_edge)``, int32. The edge set equals the host
    cKDTree build ``core.multiscale.build_multiscale_from_points`` (slot
    order differs): the training data path's ``graph_source='graphx'``.
    """
    pts = np.asarray(points, np.float32)
    levels = tuple(level_sizes)
    if pts.shape[0] != levels[-1]:
        raise ValueError(f"points ({pts.shape[0]}) must match finest level "
                         f"({levels[-1]})")
    grids = tuple(hashgrid.calibrate_spec(pts[:n], k, n_points=n)
                  for n in levels)
    ms = MultiscaleSpec(level_sizes=levels, k=k, grids=grids)
    s, r, em = make_edges_fn(ms)(
        torch.from_numpy(pts).to(resolve(device)), levels[-1])
    em = em.cpu().numpy()
    return (s.cpu().numpy()[em].astype(np.int32),
            r.cpu().numpy()[em].astype(np.int32),
            ms.level_of_edge[em])


def make_prefill_fn(cfg: GNNConfig, ms: MultiscaleSpec, *,
                    norm_in: Stats = None):
    """Rollout prefill: ``prefill(points, normals, n_valid)`` -> graph dict.

    The multi-scale edge set (the kNN kernel, once per level) and the
    step-invariant features: the graph-once half of graph-once/step-many,
    in the :func:`make_featurizer` layout the rollout engine parks in its
    slot table. The same operations as :func:`make_infer_fn` up to the
    model, so a one-step rollout is bit-equal to single-shot serving.
    """
    featurize = make_featurizer(cfg, norm_in=norm_in)

    @torch.no_grad()
    def prefill(points, normals, n_valid):
        points = points.float()
        senders, receivers, emask = multiscale_edges(points, n_valid, ms)
        return featurize(points, normals, senders, receivers, emask)

    return prefill


def make_generate_fn(cfg: GNNConfig, *, steps: int, norm_out: Stats = None):
    """Rollout generate: ``gen(model, graph, state, remaining) -> (state,
    remaining')``.

    Every graph leaf carries a leading slot axis S, ``state`` is (S, N,
    node_out) and ``remaining`` (S,) host integers count the steps still
    owed per slot. Each lane with ``remaining > 0`` advances
    ``min(remaining, steps)`` physics steps through :func:`make_step_fn`,
    one lane at a time (the JAX package's vmap lanes, written as a loop:
    one lane-step's edge activations are the only large buffer), and its
    slot of ``state`` is overwritten in place. Frozen lanes are skipped, so
    they keep their state and launch nothing. ``remaining'`` is
    ``max(remaining - steps, 0)``, computed on the host.
    """
    step = make_step_fn(cfg, norm_out=norm_out)

    @torch.no_grad()
    def gen(model, graph, state, remaining):
        rem = np.asarray(remaining, np.int64)
        for s in np.flatnonzero(rem > 0):
            lane = {k: v[s] for k, v in graph.items()}
            st = state[s]
            for _ in range(min(int(rem[s]), steps)):
                st = step(model, lane, st)
            state[s].copy_(st)
        return state, np.maximum(rem - steps, 0)

    return gen
