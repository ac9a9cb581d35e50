"""Model construction (counterpart of ``repro.models``)."""
from __future__ import annotations

from .lm import LM


def build_model(cfg) -> LM:
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: encoder-decoder models are not "
                         f"ported yet")
    return LM(cfg)
