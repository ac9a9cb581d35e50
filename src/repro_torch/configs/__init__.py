"""Architecture registry. Only ``qwen3-14b`` is ported so far; the other
architectures of the reference are named so that asking for one says so."""
from __future__ import annotations

from typing import Dict

from . import qwen3_14b
from .base import ArchConfig, MoEConfig, SSMConfig  # noqa: F401

ARCHS: Dict[str, ArchConfig] = {qwen3_14b.CONFIG.name: qwen3_14b.CONFIG}

#: architectures the JAX package has and this package does not yet
NOT_PORTED = ("internvl2-76b", "gemma3-1b", "minitron-4b", "qwen1.5-110b",
              "phi3.5-moe-42b-a6.6b", "olmoe-1b-7b", "whisper-small",
              "jamba-1.5-large-398b", "falcon-mamba-7b")


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; the PyTorch port "
                       f"has {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
