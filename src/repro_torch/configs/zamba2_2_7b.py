"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242]

54L d_model=2560 (d_inner=5120, 80 heads of 64, d_state=64); one *shared*
attention+MLP block (32H kv=32, d_ff=10240) applied after every 6 mamba
layers, fed concat(hidden, embedding).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, d_conv=4, n_groups=1,
                  chunk=128),
    hybrid_attn_every=6,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=256, hybrid_attn_every=2,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=32, d_conv=4, n_groups=1,
                  chunk=32),
)
