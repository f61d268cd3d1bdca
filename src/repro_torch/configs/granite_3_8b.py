"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family]: dense decoder,
GQA (kv=8), SwiGLU, RMSNorm, RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
