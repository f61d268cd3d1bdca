"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder; the conv and mel
frontend is stubbed (the caller supplies 1,500 frame embeddings). MHA
(kv = 20), LayerNorm, a plain GELU MLP, sinusoidal positions (no rope)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                  # decoder layers
    encoder_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    use_rope=False,
    norm="layernorm",
    act="gelu",
    glu=False,
    frontend="audio",
    n_frontend_tokens=1500,
    source="arXiv:2212.04356",
)
