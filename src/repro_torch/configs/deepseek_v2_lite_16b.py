"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434]

27L d_model=2048 16H, per-expert d_ff=1408, vocab=102400. Layer 0 uses a dense
FFN (d_ff=10944) as in the HF config. MLA: q projected directly
(q_lora_rank=0 in the Lite variant), kv_lora_rank=512, nope/rope head dims
128/64, v_head_dim=128. Trained with FSDP (``fsdp``: parameters also sharded
over the ``data`` axis).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff=1408,
                  first_dense_layers=1, first_dense_d_ff=10944,
                  capacity_factor=1.25),
    fsdp=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
    vocab_size=128,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff=32,
                  first_dense_layers=1, first_dense_d_ff=64,
                  capacity_factor=1.25),
    fsdp=False,
)
