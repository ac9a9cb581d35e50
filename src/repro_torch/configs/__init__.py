"""Architecture registry: the decoder-only architectures of the reference
— dense, MoE, pure SSM (mamba) and hybrid. The encoder-decoder and
stub-frontend architectures are named so that asking for one says so."""
from __future__ import annotations

from typing import Dict

from . import (falcon_mamba_7b, gemma3_1b, jamba_1_5_large, minitron_4b,
               olmoe_1b_7b, phi3_5_moe, qwen1_5_110b, qwen3_14b)
from .base import ArchConfig, MoEConfig, ShapeConfig, SSMConfig  # noqa: F401
from .shapes import ALL_SHAPES, shapes_for, skipped_shapes_for  # noqa: F401

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma3_1b, minitron_4b, qwen3_14b, qwen1_5_110b, phi3_5_moe,
              olmoe_1b_7b, jamba_1_5_large, falcon_mamba_7b)}

#: architectures the JAX package has and this package does not yet
NOT_PORTED = ("internvl2-76b", "whisper-small")


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; the PyTorch port "
                       f"has {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
