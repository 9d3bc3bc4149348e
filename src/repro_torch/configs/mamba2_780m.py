"""mamba2-780m [ssm] — SSD, attention-free. [arXiv:2405.21060]

48L d_model=1536 (d_inner=3072, 48 heads of 64, d_state=128), vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=48, num_kv_heads=48,
    d_ff=0, vocab_size=50280, attn_type="none",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, n_groups=1,
                  chunk=128),
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=4, d_model=128, num_heads=4, vocab_size=256,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, d_conv=4, n_groups=1,
                  chunk=32),
)
