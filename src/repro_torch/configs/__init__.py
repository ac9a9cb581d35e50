"""Architecture registry: the reference's ten architectures — dense,
MoE, pure SSM (mamba), hybrid, the encoder-decoder (whisper-small) and
the stub-frontend VLM (internvl2-76b)."""
from __future__ import annotations

from typing import Dict

from . import (falcon_mamba_7b, gemma3_1b, internvl2_76b, jamba_1_5_large,
               minitron_4b, olmoe_1b_7b, phi3_5_moe, qwen1_5_110b, qwen3_14b,
               whisper_small)
from .base import ArchConfig, MoEConfig, ShapeConfig, SSMConfig  # noqa: F401
from .shapes import ALL_SHAPES, shapes_for, skipped_shapes_for  # noqa: F401

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (internvl2_76b, gemma3_1b, minitron_4b, qwen3_14b, qwen1_5_110b,
              phi3_5_moe, olmoe_1b_7b, whisper_small, jamba_1_5_large,
              falcon_mamba_7b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
