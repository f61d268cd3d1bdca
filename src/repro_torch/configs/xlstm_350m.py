"""xLSTM-350M [arXiv:2405.04517]: mLSTM and sLSTM blocks (one sLSTM in
every 4), an O(1) recurrent state in place of a KV cache."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                        # blocks carry their own up/down projections
    vocab_size=50304,
    use_rope=False,
    ssm=SSMConfig(
        kind="xlstm",
        d_conv=4,
        expand=2,
        chunk_size=64,
        n_ssm_heads=4,
        slstm_every=4,
    ),
    supports_long_context=True,
    param_sharding="dp",           # 350M parameters: replicate
    serve_param_sharding="dp",
    source="arXiv:2405.04517",
)
