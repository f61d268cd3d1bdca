"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: VLM, a Pixtral-ViT frontend
(stubbed: the caller supplies patch embeddings, which ``vision_proj`` maps
into the decoder) and a Mistral-Nemo-style decoder. GQA (kv=8), head_dim
128, SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="vision",
    n_frontend_tokens=1024,       # stubbed ViT patch embeddings
    source="hf:mistralai/Pixtral-12B-2409",
)
