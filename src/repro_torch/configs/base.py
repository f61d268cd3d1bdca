"""GNN configuration: a copy of ``GNNConfig`` from the JAX package.

Field names, defaults and ``reduced()`` are identical so configs round-trip
between the two packages. Fields the port does not act on yet (serving
autoscaling, sharding, telemetry, cold start, resilience, rollouts) are kept
for that round-trip and ignored here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GNNConfig:
    """MeshGraphNet / X-MeshGraphNet configuration (the paper's own model).

    ``agg_impl`` is ignored by the port: aggregation dispatches by device
    (CUDA tensor -> the hand-written segment-sum kernel, CPU tensor -> its
    plain PyTorch version). kNN dispatches the same way.
    """

    name: str = "xmgn"
    family: str = "gnn"
    node_in: int = 24                  # 3 pos + 3 normal + 18 fourier
    edge_in: int = 4                   # relative pos (3) + distance (1)
    node_out: int = 4                  # pressure + 3 wall-shear components
    hidden: int = 512
    n_mp_layers: int = 15              # message-passing layers == halo size
    mlp_layers: int = 2
    act: str = "silu"
    norm: str = "layernorm"            # per-partition-local (no batch stats)
    k_neighbors: int = 6
    levels: Tuple[int, ...] = (500_000, 1_000_000, 2_000_000)
    n_partitions: int = 21
    halo: int = 15                     # == n_mp_layers
    fourier_freqs: Tuple[float, ...] = (2.0, 4.0, 8.0)  # x pi
    graph_source: str = "host"
    agg_impl: str = "xla"              # ignored by the port (see docstring)
    bucket_policy: str = "static"
    max_live_buckets: int = 8
    bucket_granularity: int = 64
    bucket_quantiles: Tuple[float, ...] = (0.5, 0.9)
    bucket_refit_every: int = 32
    bucket_hist_len: int = 1024
    shard_pad_factor: float = 1.3
    telemetry: bool = False
    trace_dir: str = ""
    profile_capture: bool = False
    compile_cache_dir: str = ""
    request_timeout_s: float = 0.0
    max_queue_depth: int = 0
    shed_policy: str = "reject"
    worker_max_restarts: int = 3
    worker_backoff_s: float = 0.05
    worker_backoff_max_s: float = 2.0
    nonfinite_guard: bool = True
    keep_ckpts: int = 0
    rollout_state_feats: bool = False
    rollout_integrator: str = "direct"  # "direct" | "residual"
    rollout_slots: int = 8
    rollout_steps_per_flush: int = 4
    rollout_timeout_s: float = 0.0
    noise_std: float = 0.0
    remat: bool = True                 # no-op under torch.no_grad (serving)
    dtype: str = "float32"
    source: str = "arXiv X-MeshGraphNet (NVIDIA 2024)"

    @property
    def node_in_eff(self) -> int:
        """Node-encoder input width: static features (+ state when fed back)."""
        return self.node_in + (self.node_out if self.rollout_state_feats else 0)

    def replace(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "GNNConfig":
        return self.replace(hidden=64, n_mp_layers=3, halo=3,
                            levels=(128, 256, 512), n_partitions=4)
