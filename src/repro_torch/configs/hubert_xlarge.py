"""hubert-xlarge [audio] — encoder only, the w2v2 architecture.
[arXiv:2106.07447]

48L d_model=1280 16H (kv=16) of 80, d_ff=5120, vocab (target classes)
504. The convolutional feature extractor is a stub, as in the reference:
a batch carries precomputed frame embeddings (B, S, d_model).
Bidirectional attention; no decode step.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    modality="audio", causal=False, encoder_only=True, act="gelu",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=32,
)
