"""Gemma2-9B [arXiv:2408.00118]: alternating local (window 4096) and global
attention, attention logit softcap 50, final softcap 30, pre and post norms,
GeGLU, embeddings scaled by sqrt(d)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=1e4,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern="alt_local_global",
    act="gelu",
    post_norms=True,
    scale_embeddings=True,
    supports_long_context=True,
    source="arXiv:2408.00118",
)
