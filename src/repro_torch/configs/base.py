"""Configurations: copies of ``GNNConfig``, ``UNetConfig``, ``MoEConfig``
and ``ModelConfig`` from the JAX package.

``GNNConfig``'s and ``UNetConfig``'s field names, defaults and ``reduced()``
are identical so configs round-trip between the two packages (a deploy
artifact carries a ``GNNConfig``). The GNN server and the trainer read
``compile_cache_dir`` (the kernels' build directory); the trainer reads
``graph_source``, ``nonfinite_guard``, ``noise_std``,
``remat``, ``keep_ckpts`` and ``telemetry``/``trace_dir``/``profile_capture``,
the GNN server the ``bucket_*`` autoscaling knobs, ``max_live_buckets``,
``shard_pad_factor``,
the resilience knobs (``request_timeout_s``, ``max_queue_depth``,
``shed_policy``, ``worker_*``, ``nonfinite_guard``) and the telemetry
fields, and its rollout engine ``rollout_slots``,
``rollout_steps_per_flush``, ``rollout_timeout_s``, and (through
``MeshGraphNet.step``) ``rollout_state_feats`` and ``rollout_integrator``.
``ModelConfig``
keeps only the fields the decoder reads (dense, MoE and the vision prefix);
the sharding, remat, SSM and encoder-decoder fields come with the slices
that read them. ``MoEConfig`` is copied field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style capacity
    routing)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # deepseek-moe: always-on shared experts
    first_dense_layers: int = 0        # deepseek-moe: layer 0 is a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2    # load-balance auxiliary loss weight


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only transformer: dense, MoE, or with a vision prefix."""

    name: str
    family: str                        # "dense" | "moe" | "vlm" (ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # None -> d_model // n_heads
    vocab_pad_to: int = 256
    rope_theta: float = 1e4
    use_rope: bool = True
    qk_norm: bool = False              # per-head RMSNorm on q, k
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_pattern: str = "global"      # "global" | "alt_local_global"
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm"
    act: str = "silu"                  # "silu" | "gelu"
    glu: bool = True                   # gated FFN (SwiGLU/GeGLU)
    post_norms: bool = False           # gemma2: post-norms around attn/ffn
    scale_embeddings: bool = False     # gemma2: embeddings * sqrt(d)
    moe: Optional[MoEConfig] = None
    frontend: Optional[str] = None     # None | "vision" (stubbed prefix)
    n_frontend_tokens: int = 0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                   # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """A smoke-test-sized variant (2 layers, d 128, hd 32; MoE: 4
        experts top-2 of width 64, at most 1 dense first layer; 16 frontend
        tokens), as the JAX package's ``ModelConfig.reduced`` gives for
        these families."""
        kw = dict(
            n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2), head_dim=32, d_ff=256,
            vocab_size=512, vocab_pad_to=64,
            n_frontend_tokens=16 if self.frontend else 0,
            sliding_window=16 if self.sliding_window else None,
            dtype="float32")
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        return self.replace(**kw)


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
    remat: bool = True                 # checkpoint each MP layer (autograd)
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


@dataclass(frozen=True)
class UNetConfig:
    """X-UNet3D (paper SVI): 3D UNet with attention gates + halo partitioning."""

    name: str = "xunet3d"
    family: str = "unet"
    in_channels: int = 16              # coords + fourier + sdf + sdf grads
    out_channels: int = 4              # velocity (3) + pressure
    base_channels: int = 64
    depth: int = 3
    blocks_per_level: int = 2
    kernel_size: int = 3
    pool: int = 2
    act: str = "gelu"
    attention_gates: bool = True
    halo: int = 40
    n_partitions: int = 10
    grid: Tuple[int, int, int] = (800, 304, 224)   # bbox / 1.5cm voxels
    dtype: str = "float32"
    source: str = "arXiv X-MeshGraphNet (NVIDIA 2024) SVI"

    def replace(self, **kw) -> "UNetConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "UNetConfig":
        return self.replace(base_channels=8, depth=2, grid=(32, 16, 16),
                            halo=8, n_partitions=2)
