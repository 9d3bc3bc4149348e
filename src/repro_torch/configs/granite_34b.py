"""granite-34b [dense] — llama-arch, code, MQA. [arXiv:2405.04324]

88L d_model=6144 48H (MQA kv=1), d_ff=24576, vocab=49152. Trained with
FSDP (``fsdp``: parameters also sharded over the ``data`` axis).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, act="gelu", fsdp=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    vocab_size=256, fsdp=False,
)
