"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-32B]

64L d_model=5120 40H (kv=40), d_ff=27392, vocab=152064. Trained with FSDP
(``fsdp``: parameters also sharded over the ``data`` axis).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064, qkv_bias=True, fsdp=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, fsdp=False,
)
