"""Model construction (counterpart of ``repro.models``)."""
from __future__ import annotations

from .encdec import EncDecLM  # noqa: F401
from .lm import LM  # noqa: F401
from .model_zoo import (batch_specs, build_model, cache_specs,  # noqa: F401
                        decode_token_spec, make_batch)
