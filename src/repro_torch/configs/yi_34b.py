"""Yi-34B [arXiv:2403.04652]: llama-architecture dense decoder, GQA (kv=8),
56 heads x 128 = 7168 = d_model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    source="arXiv:2403.04652",
)
