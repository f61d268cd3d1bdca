"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained MoE, 64 routed experts
top-6 + 2 shared experts, first layer dense; MHA (kv=16)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                    # per-expert hidden (fine-grained)
    vocab_size=102400,
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        first_dense_layers=1,
    ),
    source="arXiv:2401.06066",
)
