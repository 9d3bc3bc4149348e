"""deepseek-coder-33b [dense] — llama-arch. [arXiv:2401.14196]

62L d_model=7168 56H (GQA kv=8), d_ff=19200, vocab=32256. Trained with
FSDP (``fsdp``: parameters also sharded over the ``data`` axis).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, fsdp=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, fsdp=False,
)
