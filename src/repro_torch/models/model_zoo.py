"""Model construction and random batches (counterpart of
``repro.models.model_zoo``).

``build_model`` returns the model for an architecture; ``make_batch``
draws a random batch for an input shape from an explicit
``torch.Generator``, on the generator's device, with the reference's
keys, shapes and dtypes. The reference's ``batch_specs`` /
``cache_specs`` / ``decode_token_spec`` feed only its multi-device dry
run and are not ported.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from .encdec import EncDecLM
from .lm import LM

Model = Union[LM, EncDecLM]


def build_model(cfg) -> Model:
    """``EncDecLM`` for an encoder-decoder architecture, else the
    decoder-only ``LM`` (token or stub-frontend input)."""
    if cfg.is_encdec:
        return EncDecLM(cfg)
    return LM(cfg)


def make_batch(cfg, shape, generator: torch.Generator,
               batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """A random batch (B = ``batch_override`` or the shape's global
    batch, S its sequence length), drawn in key order:

    * token models: ``tokens`` [B, S] int32, plus ``labels`` [B, S] in
      train mode;
    * encoder-decoder: ``embeds`` [B, S, D] (standard normal, cast to the
      model dtype), plus ``tokens`` and ``labels`` [B, decoder_len] in
      train mode;
    * stub frontend: ``embeds`` [B, S, D], plus ``labels`` [B, S] in
      train mode."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    dev = generator.device
    train = shape.mode == "train"

    def ids(size):
        return torch.randint(0, cfg.vocab_size, size, generator=generator,
                             device=dev, dtype=torch.int32)

    if cfg.is_encdec or cfg.frontend is not None:
        out = {"embeds": torch.randn((b, s, cfg.d_model), generator=generator,
                                     dtype=torch.float32,
                                     device=dev).to(cfg.dtype)}
        if train and cfg.is_encdec:
            out["tokens"] = ids((b, cfg.decoder_len))
            out["labels"] = ids((b, cfg.decoder_len))
        elif train:
            out["labels"] = ids((b, s))
        return out
    names = ("tokens", "labels") if train else ("tokens",)
    return {n: ids((b, s)) for n in names}
