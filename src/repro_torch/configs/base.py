"""Architecture configuration schema (a JAX-free copy of
``repro.configs.base``).

One ``ArchConfig`` per architecture lives in ``configs/<id>.py`` with
the exact published dimensions; ``.reduced()`` gives the same-family
tiny config the CPU tests use. ``dtype`` maps ``param_dtype`` to a
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    every_n_layers: int = 1
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads
    # ('attn'|'mamba'|'local'|'global') repeated over depth:
    # num_layers = k * len(pattern) + leftover
    layer_pattern: Tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # for 'local' layers
    rope_theta: float = 10000.0
    activation: str = "swiglu"        # swiglu | gelu | relu2
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0
    decoder_len: int = 448
    frontend: Optional[str] = None    # None | 'audio' | 'vision'
    tie_embeddings: bool = True
    scale_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / mostly-local attention)."""
        kinds = set(self.layer_pattern)
        if "mamba" in kinds:
            return True
        n_local = sum(1 for k in self.layer_pattern if k == "local")
        return n_local >= 0.8 * len(self.layer_pattern)

    def periods(self) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
        """(n_periods, pattern, leftover_kinds) — the reference stacks
        each pattern position over the periods."""
        p = len(self.layer_pattern)
        n = self.num_layers // p
        leftover = self.num_layers - n * p
        return n, self.layer_pattern, self.layer_pattern[:leftover]

    def layer_kinds(self) -> Tuple[str, ...]:
        n, pat, left = self.periods()
        return pat * n + left

    def moe_on_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        n = self.moe.every_n_layers
        return idx % n == n - 1

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests."""
        pat = self.layer_pattern
        n_layers = max(2, 2 * len(pat))
        if len(pat) > 4:
            n_layers = len(pat)
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k))
        heads = min(4, self.num_heads)
        kv = min(self.num_kv_heads, heads)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            encoder_layers=2 if self.encoder_layers else 0,
            decoder_len=16 if self.is_encdec else self.decoder_len,
            sliding_window=8 if self.sliding_window else None,
            moe=moe,
            ssm=dataclasses.replace(self.ssm, dt_rank=8) if self.ssm else None,
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
