"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8 MoE, GQA (kv=4),
QK-RMSNorm, head_dim 128."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # per-expert hidden
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_ff_expert=768,
    ),
    grad_accum=4,                  # microbatches: the MoE dispatch buffers
    source="hf:Qwen/Qwen3-30B-A3B",
)
