"""starcoder2-7b [dense] — GQA, RoPE. [arXiv:2402.19173]

32L d_model=4608 36H (GQA kv=4), d_ff=18432, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, act="gelu", qkv_bias=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256,
)
