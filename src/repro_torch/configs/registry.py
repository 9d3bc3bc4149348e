"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Every id of the JAX registry: the dense GQA family, the MoE family with
GQA or MLA attention (deepseek-v2-lite-16b), the SSM family
(mamba2-780m), the hybrid (zamba2-2.7b: Mamba2 groups and one shared
attention block), the vision prefix-LM (paligemma-3b) and the audio
encoder (hubert-xlarge). An unknown id raises ``KeyError``.

Applicability of the input shapes (the reference's rules):
  * ``long_500k`` needs sub-quadratic sequence mixing: only ssm/hybrid;
  * encoder-only archs (hubert) have no decode step: no decode shapes.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, deepseek_v2_lite_16b,
                                 granite_34b, granite_moe_1b_a400m,
                                 hubert_xlarge, mamba2_780m, paligemma_3b,
                                 qwen1_5_32b, starcoder2_7b, zamba2_2_7b)
from typing import List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCH_IDS = [
    "mamba2-780m",
    "granite-moe-1b-a400m",
    "deepseek-v2-lite-16b",
    "zamba2-2.7b",
    "paligemma-3b",
    "hubert-xlarge",
    "qwen1.5-32b",
    "starcoder2-7b",
    "deepseek-coder-33b",
    "granite-34b",
]

_MODULES = {"starcoder2-7b": starcoder2_7b,
            "granite-moe-1b-a400m": granite_moe_1b_a400m,
            "deepseek-coder-33b": deepseek_coder_33b,
            "granite-34b": granite_34b,
            "qwen1.5-32b": qwen1_5_32b,
            "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
            "mamba2-780m": mamba2_780m,
            "zamba2-2.7b": zamba2_2_7b,
            "paligemma-3b": paligemma_3b,
            "hubert-xlarge": hubert_xlarge}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def applicable_shapes(arch: str) -> List[ShapeSpec]:
    cfg = get_config(arch)
    out = []
    for s in SHAPES.values():
        if cfg.encoder_only and s.kind == "decode":
            continue
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return out


def all_cells() -> List[tuple]:
    return [(a, s.name) for a in ARCH_IDS for s in applicable_shapes(a)]
