"""Model construction (counterpart of ``repro.models``)."""
from __future__ import annotations

from .encdec import EncDecLM  # noqa: F401
from .lm import LM  # noqa: F401
from .model_zoo import build_model, make_batch  # noqa: F401
