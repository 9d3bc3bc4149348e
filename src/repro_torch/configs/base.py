"""Configuration dataclasses for models, shapes, adapters and training.

A copy of ``repro/configs/base.py``'s ``ShapeSpec``, ``SHAPES``,
``ModelConfig``, ``AdapterConfig``, ``TrainConfig``, ``RunConfig``,
``MoEConfig``, ``MLAConfig`` and ``SSMConfig``, so the port reads
configurations without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: (seq_len, global_batch, kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM-family shapes (the reference's, which
# ``analysis.roofline.model_flops`` reads by name).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    top_k: int = 0
    num_shared: int = 0            # always-on shared experts (DeepSeek-V2 style)
    d_ff: int = 0                  # per-expert hidden dim
    first_dense_layers: int = 0    # leading layers that use a dense FFN instead
    first_dense_d_ff: int = 0      # hidden dim of those dense layers
    capacity_factor: float = 1.25  # train-time token capacity per expert
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => project q directly from d_model
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD mixer."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 128               # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    attn_type: str = "gqa"         # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"              # silu (SwiGLU) | gelu (vanilla MLP)
    tie_embeddings: bool = False
    causal: bool = True
    encoder_only: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid (zamba2): a single *shared* attention block applied after every
    # ``hybrid_attn_every`` SSM layers (weights reused at every site).
    hybrid_attn_every: int = 0
    modality: str = "text"         # text | vision | audio
    num_prefix_embeds: int = 0
    # Distribution policy: shard parameters along the ``data`` axis too
    # (``launch.sharding``).
    fsdp: bool = False
    # Head-group padding: q heads per kv group (and kv heads) padded with
    # zero-initialised dead heads; the model function is unchanged.
    pad_heads_to: int = 0
    pad_kv_to: int = 0
    attn_repeat_kv: bool = False
    remat: str = "full"            # full | dots | none: per-layer remat

    @property
    def subquadratic(self) -> bool:
        """Sub-quadratic sequence mixing (drives long_500k's
        applicability)."""
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded to a multiple of 256; pad logits are
        masked to -1e30."""
        m = 256
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def prefix_rows(self) -> int:
        """The positions a request's vision prefix (its patch embeddings)
        holds before its prompt, in the sequence and in the KV cache; 0
        for the other modalities."""
        return self.num_prefix_embeds if self.modality == "vision" else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AdapterConfig:
    """The paper's contribution, as a first-class config."""

    kind: str = "none"             # none | shira | lora | dora | shira-dora
    mask: str = "wm"               # rand (others wait: lax.top_k tie order)
    sparsity: float = 0.99         # fraction of *zeros* in the mask
    rank: int = 32
    alpha: float = 1.0             # inference-time strength W + alpha * S
    lora_alpha: float = 64.0
    target_modules: Tuple[str, ...] = (
        "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
        "in_proj", "out_proj", "w_dkv", "w_uk", "w_uv",
    )
    struct_rows: int = 8
    struct_cols: int = 8
    packed: bool = True
    sparse_grad_sync: bool = False


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    learning_rate: float = 5e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 10
    schedule: str = "linear"       # linear | cosine | constant
    total_steps: int = 300
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    microbatch: int = 0            # 0 => no gradient accumulation


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeSpec
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
