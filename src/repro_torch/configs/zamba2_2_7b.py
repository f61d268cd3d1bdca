"""Zamba2-2.7B [arXiv:2411.15242]: a hybrid of Mamba2 blocks and ONE shared
attention+FFN block applied every 6 layers (9 occurrences, each with its own
KV cache), ssm_state 64, attention head_dim 80. As in the JAX config, the
per-occurrence LoRA deltas on the shared block are omitted. The Mamba2
state is O(1) in sequence length."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,                   # 9 superblocks x (5 mamba2 + 1 shared attn)
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,                    # shared attention block's FFN
    vocab_size=32000,
    rope_theta=1e4,
    ssm=SSMConfig(
        kind="mamba2",
        d_state=64,
        d_conv=4,
        expand=2,
        chunk_size=64,
        n_ssm_heads=80,            # d_inner 5120 / head_dim 64
    ),
    attn_every=6,
    supports_long_context=True,
    source="arXiv:2411.15242",
)
