"""Model construction and random batches (counterpart of
``repro.models.model_zoo``).

``build_model`` returns the model for an architecture; ``make_batch``
draws a random token batch for an input shape from an explicit
``torch.Generator``, on the generator's device. The reference's
``batch_specs`` / ``cache_specs`` / ``decode_token_spec`` feed only its
multi-device dry run, and its embedding batches only the stub-frontend
and encoder-decoder models: none is ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from .lm import LM


def build_model(cfg) -> LM:
    """The decoder-only LM (``LM`` refuses the stub-frontend and
    encoder-decoder architectures)."""
    return LM(cfg)


def make_batch(cfg, shape, generator: torch.Generator,
               batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """``tokens`` [B, S] int32 in the vocabulary (B = ``batch_override``
    or the shape's global batch), plus ``labels`` of the same shape in
    train mode."""
    if cfg.is_encdec or cfg.frontend is not None:
        raise ValueError(f"{cfg.name}: embedding batches (stub-frontend and "
                         f"encoder-decoder models) are not ported yet")
    b = batch_override or shape.global_batch
    size = (b, shape.seq_len)
    names = ("tokens", "labels") if shape.mode == "train" else ("tokens",)
    return {n: torch.randint(0, cfg.vocab_size, size, generator=generator,
                             device=generator.device, dtype=torch.int32)
            for n in names}
