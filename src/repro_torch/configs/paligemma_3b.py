"""paligemma-3b [vlm] — SigLIP + gemma backbone. [arXiv:2407.07726]

18L d_model=2048 8H (MQA kv=1) of 256, d_ff=16384, vocab=257216, tied.
The vision frontend is a stub, as in the reference: a batch carries 256
precomputed patch embeddings of d_model, prepended as a fully visible
prefix (prefix-LM attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    modality="vision", num_prefix_embeds=256,
    act="gelu", tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, num_prefix_embeds=16,
)
