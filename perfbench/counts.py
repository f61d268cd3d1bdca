"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
of the useful work, counted from shapes.

Useful work leaves out what an implementation adds on its own account:
bucket padding, masked edge slots, halo rows and planes, and recomputation
under remat. A share of a peak then reads the same work whatever computes
it, so a change that drops padding shows as a faster run of the same work,
never as less work.

Operations count 2 per multiply-add of every matrix product and
convolution; elementwise work (activations, norms, the segment sums' adds)
is left out. Bytes count each input byte read once and each output byte
written once.
"""
from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
# The `mfu` shares divide by the TF32 tensor-core rate, not by the 67 TFLOP/s
# of f32 on the CUDA cores: both configurations compute in f32, and an
# f32-faithful route through the tensor cores (split TF32) could pass 67 and
# still be exact, but it stays under 494.7.
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

F32 = 4
I32 = 4


def dense_flops(rows: int, dims: Sequence[int]) -> float:
    """An MLP of dense layers ``dims[0] -> dims[1] -> ...`` over ``rows``."""
    return float(sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:])))


def mgn_forward_flops(cfg, n_nodes: int, n_edges: int) -> float:
    """One MeshGraphNet forward over a graph of ``n_nodes`` nodes and
    ``n_edges`` valid directed edges: the two encoders, ``n_mp_layers``
    processor layers (edge MLP over [h_s, h_r, e], node MLP over [h, agg])
    and the decoder."""
    h = cfg.hidden
    hid = [h] * cfg.mlp_layers
    f = dense_flops(n_nodes, [cfg.node_in] + hid + [h])
    f += dense_flops(n_edges, [cfg.edge_in] + hid + [h])
    f += cfg.n_mp_layers * (dense_flops(n_edges, [3 * h] + hid + [h])
                            + dense_flops(n_nodes, [2 * h] + hid + [h]))
    return f + dense_flops(n_nodes, [h] + hid + [cfg.node_out])


def segment_sum_bytes(n_edges: int, n_nodes: int, d: int) -> float:
    """One segment sum of ``n_edges`` valid rows of width ``d`` into
    ``n_nodes`` rows over a CSR: the rows and the permutation read, the row
    pointers read, the sums written."""
    return float(n_edges * d * F32 + n_edges * I32 + (n_nodes + 1) * I32
                 + n_nodes * d * F32)


def segment_sum_backward_bytes(n_edges: int, n_nodes: int, d: int) -> float:
    """Its transpose: ``n_nodes`` gradient rows and the CSR read, one row
    written for each of the ``n_edges`` valid edges."""
    return float(n_nodes * d * F32 + n_edges * I32 + (n_nodes + 1) * I32
                 + n_edges * d * F32)


def knn_bytes(n: int, k: int) -> float:
    """The k nearest neighbours of each of ``n`` points among the others,
    by the algorithm's own shapes: the query positions read, the positions
    of the k candidates within each query's k-th neighbour radius read, and
    the k ids and squared distances written. Whatever candidates a search
    structure visits beyond those is the implementation's, not the work."""
    return float(n * 3 * F32 + n * k * 3 * F32 + n * k * (I32 + F32))


def mgn_aggregation_bytes(cfg, n_nodes: int, n_edges: int) -> float:
    """The segment sums of one MeshGraphNet forward: one a processor
    layer, ``n_edges`` valid edge rows into ``n_nodes`` rows."""
    return cfg.n_mp_layers * segment_sum_bytes(n_edges, n_nodes, cfg.hidden)


def mgn_train_segment_sum_bytes(cfg, n_nodes: int, n_edges: int) -> float:
    """The segment sums of one training step over the whole graph, without
    halos or recomputation: each layer's aggregation, and the backward of
    its two gathers (``h[senders]``, ``h[receivers]``), each a sum of edge
    rows into node rows."""
    return 3 * mgn_aggregation_bytes(cfg, n_nodes, n_edges)


def mgn_train_segment_sum_backward_bytes(cfg, n_nodes: int,
                                         n_edges: int) -> float:
    """The aggregations' backward of one training step over the whole
    graph: one a processor layer."""
    return cfg.n_mp_layers * segment_sum_backward_bytes(n_edges, n_nodes,
                                                        cfg.hidden)


def unet_flops(cfg, grid: Sequence[int]) -> float:
    """Every convolution and gate of one X-UNet3D forward over an (X, Y, Z)
    grid, unpartitioned (no halo planes)."""
    k3 = cfg.kernel_size ** 3
    ch = [cfg.base_channels * 2 ** i for i in range(cfg.depth)]
    vox = [grid[0] * grid[1] * grid[2] / 8 ** i for i in range(cfg.depth)]
    n = cfg.blocks_per_level
    f, cin = 0.0, cfg.in_channels
    for i in range(cfg.depth):
        f += 2 * k3 * (cin + (n - 1) * ch[i]) * ch[i] * vox[i]
        cin = ch[i]
    for i in reversed(range(cfg.depth - 1)):
        f += 2 * ch[i + 1] * ch[i] * vox[i]                # up conv
        if cfg.attention_gates:
            ci = max(ch[i] // 2, 1)
            f += 2 * (2 * ch[i] * ci + ci) * vox[i]
        f += 2 * k3 * (2 * ch[i] + (n - 1) * ch[i]) * ch[i] * vox[i]
    return f + 2 * ch[0] * cfg.out_channels * vox[0]


def roofline_pct(n_bytes: float, n_flops: float, seconds: float,
                 flops_per_s: float = PEAK_F32_FLOPS) -> float:
    """The least time the work could take on the chip (bytes over HBM
    bandwidth or operations over ``flops_per_s``, the larger) as a
    percentage of ``seconds``."""
    bound = max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)
    return 100.0 * bound / seconds


def mfu_pct(n_flops: float, seconds: float) -> float:
    """Useful operations over ``seconds`` as a percentage of the TF32
    tensor-core peak."""
    return 100.0 * n_flops / (PEAK_TF32_FLOPS * seconds)
