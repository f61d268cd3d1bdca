"""StarCoder2-15B [arXiv:2402.19173]: dense decoder, GQA (kv=4), RoPE.
StarCoder2 uses LayerNorm and a plain (non-gated) GELU MLP with biases."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e5,
    norm="layernorm",
    act="gelu",
    glu=False,
    source="arXiv:2402.19173",
)
