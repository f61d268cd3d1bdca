"""GNN data pipeline (paper SV-C): geometry -> multi-scale point-cloud graph
-> features/targets -> normalization -> partitions with halo -> padded
stacked batches ready for the trainer.

Host numpy, copied from the JAX package (``repro.data.pipeline``) so that
both packages train on bit-equal arrays. The graph is built on the host
(``source='host'``, cKDTree) or by the hash-grid edge union serving uses
(``source='graphx'``, ``graphx.pipeline.device_multiscale_edges``: the kNN
kernel on the card), which gives the same edge set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from repro_torch.configs.base import GNNConfig
from repro_torch.core import halo as halo_lib
from repro_torch.core import partitioning
from repro_torch.core.gradient_aggregation import padded_partition_batches
from repro_torch.core.graph import Graph, relative_edge_features
from repro_torch.core.graph_build import (node_input_features, sample_surface,
                                          vertex_normals)
from repro_torch.core.multiscale import build_multiscale_from_points
from repro_torch.data import geometry as geo


def idw_interpolate(src_points: np.ndarray, src_values: np.ndarray,
                    dst_points: np.ndarray, k: int = 5) -> np.ndarray:
    """Paper SV-C: 5-nearest-neighbor inverse-distance-weighted interpolation
    of simulation fields onto the sampled point cloud."""
    tree = cKDTree(src_points)
    dist, idx = tree.query(dst_points, k=min(k, len(src_points)))
    if dist.ndim == 1:
        dist, idx = dist[:, None], idx[:, None]
    w = 1.0 / np.maximum(dist, 1e-9)
    w = w / w.sum(axis=1, keepdims=True)
    return (src_values[idx] * w[..., None]).sum(axis=1).astype(np.float32)


@dataclass
class Normalizer:
    mean: np.ndarray
    std: np.ndarray

    def encode(self, x):
        return (x - self.mean) / self.std

    def decode(self, x):
        return x * self.std + self.mean

    @staticmethod
    def fit(arrays: Sequence[np.ndarray]) -> "Normalizer":
        stacked = np.concatenate(arrays, axis=0)
        return Normalizer(mean=stacked.mean(0, keepdims=True),
                          std=stacked.std(0, keepdims=True) + 1e-8)


@dataclass
class GraphSample:
    graph: Graph
    node_feats: np.ndarray
    targets: np.ndarray
    sample_id: int


def build_sample(cfg: GNNConfig, sample_id: int,
                 use_idw: bool = False,
                 source: Optional[str] = None, device=None) -> GraphSample:
    """One geometry -> multi-scale graph + features + analytic targets.

    ``source`` (default ``cfg.graph_source``) selects the graph
    construction: ``"host"`` is the cKDTree multi-scale build; ``"graphx"``
    runs the hash-grid union serving uses on ``device`` (default: the card;
    mesh-free, no cKDTree in the edge build) and compacts its edge list to
    the host. Both give the same edge set, so training is source-agnostic.
    """
    params = geo.sample_params(sample_id)
    verts, faces = geo.car_surface(params)
    rng = np.random.default_rng(sample_id)
    n_fine = max(cfg.levels)
    points, normals = sample_surface(verts, faces, n_fine, rng)
    source = source or cfg.graph_source
    if source == "graphx":
        from repro_torch.graphx.pipeline import device_multiscale_edges
        s, r, lvl = device_multiscale_edges(points, cfg.levels,
                                            cfg.k_neighbors, device=device)
        g = Graph(positions=points, senders=s, receivers=r, normals=normals,
                  level_of_edge=lvl)
        g.edge_feats = relative_edge_features(points, s, r)
        g.validate()
    elif source == "host":
        g = build_multiscale_from_points(points, cfg.levels, cfg.k_neighbors,
                                         normals=normals)
    else:
        raise ValueError(f"unknown graph_source {source!r} "
                         "(expected 'host' | 'graphx')")
    feats = node_input_features(points, normals, cfg.fourier_freqs)
    if use_idw:
        # pipeline-faithful path: evaluate the field on the raw mesh
        # vertices (with true area-weighted vertex normals) and IDW-
        # interpolate onto the sampled cloud (paper reads .vtp and
        # interpolates onto its point cloud, SV-C)
        vert_normals = vertex_normals(verts, faces)
        field_on_mesh = geo.surface_fields(verts, vert_normals, params)
        targets = idw_interpolate(verts, field_on_mesh, points)
    else:
        targets = geo.surface_fields(points, normals, params)
    assert feats.shape[1] == cfg.node_in, (feats.shape, cfg.node_in)
    assert targets.shape[1] == cfg.node_out
    return GraphSample(graph=g, node_feats=feats, targets=targets,
                       sample_id=sample_id)


@dataclass
class PartitionedSample:
    stacked: dict                # padded (P, ...) batches for the model
    padded: dict                 # raw halo.pad_partitions output (node ids...)
    n_nodes: int
    denom: float


def build_sample_partitions(cfg: GNNConfig, s: GraphSample,
                            n_partitions: Optional[int] = None):
    """Partition + halo construction for one sample — the expensive host
    stage of :func:`partition_sample`, separated so callers can build once
    and pad several ways (common padding across samples, say) without
    re-partitioning."""
    g = s.graph
    nparts = n_partitions or cfg.n_partitions
    labels = partitioning.partition(g.senders, g.receivers, g.n_nodes,
                                    nparts, positions=g.positions)
    return halo_lib.build_partitions(g.senders, g.receivers, labels,
                                     nparts, halo_hops=cfg.halo)


def partition_sample(cfg: GNNConfig, s: GraphSample,
                     norm_in: Optional[Normalizer] = None,
                     norm_out: Optional[Normalizer] = None,
                     n_partitions: Optional[int] = None,
                     pad_nodes: Optional[int] = None,
                     pad_edges: Optional[int] = None,
                     parts=None) -> PartitionedSample:
    """Normalize + partition + pad one sample.

    ``parts`` accepts partitions prebuilt by :func:`build_sample_partitions`
    — padding already-built partitions is cheap, so discovering common pad
    dims across samples no longer costs a second partitioning pass.
    """
    g = s.graph
    feats = norm_in.encode(s.node_feats) if norm_in else s.node_feats
    targs = norm_out.encode(s.targets) if norm_out else s.targets
    if parts is None:
        parts = build_sample_partitions(cfg, s, n_partitions)
    padded = halo_lib.pad_partitions(parts, pad_nodes, pad_edges)
    stacked = padded_partition_batches(padded, feats.astype(np.float32),
                                       g.edge_feats, targs.astype(np.float32))
    return PartitionedSample(stacked=stacked, padded=padded,
                             n_nodes=g.n_nodes,
                             denom=float(g.n_nodes * cfg.node_out))


def partition_samples(cfg: GNNConfig, samples: Sequence[GraphSample],
                      norm_in: Optional[Normalizer] = None,
                      norm_out: Optional[Normalizer] = None,
                      n_partitions: Optional[int] = None
                      ) -> List[PartitionedSample]:
    """Partition a batch of samples with COMMON padding, partitioning each
    sample exactly once.

    Every step and eval forward then sees one shape: the pad dims are the
    max node/edge counts over all partitions of all samples.
    """
    parts_per = [build_sample_partitions(cfg, s, n_partitions)
                 for s in samples]
    nmax = max((p.n_nodes for parts in parts_per for p in parts), default=1)
    emax = max((p.n_edges for parts in parts_per for p in parts), default=1)
    return [partition_sample(cfg, s, norm_in, norm_out,
                             pad_nodes=nmax, pad_edges=emax, parts=parts)
            for s, parts in zip(samples, parts_per)]


def split_test_ids(drags: np.ndarray, test_frac: float = 0.1,
                   ood_frac: float = 0.2, seed: int = 0):
    """Paper SV-B split bookkeeping as a pure function.

    Returns (ood_ids, iid_ids): disjoint sorted lists whose union has exactly
    ``n_test = max(1, round(test_frac * n))`` elements. OOD ids are the
    extreme low/high ends of the ``drags`` ordering (half each, odd count
    leaning low); IID ids are drawn uniformly from the remainder.
    """
    n = len(drags)
    n_test = min(max(1, int(round(test_frac * n))), n)
    n_ood = min(n_test, max(1, int(round(ood_frac * n_test)))) \
        if n_test >= 2 else 0
    order = np.argsort(drags)
    lo, hi = (n_ood + 1) // 2, n_ood // 2
    # lo + hi = n_ood <= n, so the head and tail slices cannot overlap
    # order[n - hi:] is empty when hi == 0, so no guard is needed
    ood = [int(i) for i in order[:lo]] + [int(i) for i in order[n - hi:]]
    rest = np.setdiff1d(np.arange(n), np.asarray(ood, np.int64))
    rng = np.random.default_rng(seed)
    iid = [int(i) for i in rng.choice(rest, size=n_test - n_ood,
                                      replace=False)]
    assert not set(ood) & set(iid)
    assert len(ood) + len(iid) == n_test
    return sorted(ood), sorted(iid)


def build_dataset(cfg: GNNConfig, n_samples: int, test_frac: float = 0.1,
                  device=None):
    """Paper SV-B split: 10% test, of which 20% out-of-distribution by the
    force coefficient (extreme low/high drag proxies). ``device`` is where
    a ``graph_source='graphx'`` build runs (default: the card)."""
    samples = [build_sample(cfg, i, device=device) for i in range(n_samples)]
    norm_in = Normalizer.fit([s.node_feats for s in samples])
    norm_out = Normalizer.fit([s.targets for s in samples])
    drags = np.array([integrated_force(s)[0] for s in samples])
    ood, iid_test = split_test_ids(drags, test_frac)
    test_ids = set(ood) | set(iid_test)
    train = [s for s in samples if s.sample_id not in test_ids]
    test = [s for s in samples if s.sample_id in test_ids]
    return train, test, norm_in, norm_out


def integrated_force(s: GraphSample) -> np.ndarray:
    """Proxy aerodynamic force: surface integral of (-cp * n + tau), flow
    component. Used for the paper's Fig-5-style predicted-vs-true force R^2."""
    normals = s.graph.normals
    cp = s.targets[:, :1]
    tau = s.targets[:, 1:]
    f = (-cp * normals + tau).mean(axis=0)
    return f @ geo.FLOW_DIR[:, None]
