"""Transformer block wiring for the serving main path: pre-norm paged
attention + pre-norm dense FFN (counterpart of ``repro.models.blocks``).
Mamba and MoE blocks are not ported yet."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import attention as attn
from .layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec


def _require_ported(cfg, kind: str, use_moe: bool) -> None:
    if kind == "mamba":
        raise ValueError("mamba blocks are not ported yet")
    if use_moe:
        raise ValueError("MoE blocks are not ported yet")


def block_spec(cfg, kind: str, use_moe: bool, dtype):
    _require_ported(cfg, kind, use_moe)
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "mixer": attn.attention_spec(cfg, dtype),
            "ln2": rmsnorm_spec(cfg.d_model),
            "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation, dtype)}


def window_for(cfg, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _ffn(p, x, cfg):
    return x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                   cfg.activation)


def block_decode(p, x: torch.Tensor, cache: Dict, cache_len: torch.Tensor,
                 cfg, kind: str, use_moe: bool, pages: torch.Tensor,
                 attn_impl: str = "gather",
                 write_plan: Optional[attn.PageWritePlan] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token pass against the paged cache. x [B,1,D]; ``cache_len``
    [B] per-row lengths; ``pages`` [B,P] block table. The new token's
    K/V is written at flat position ``cache_len[b]`` (in place; lanes
    past the table or on sentinel pages drop), then attention reads
    ``cache_len + 1`` positions. ``write_plan`` (from
    :func:`attention.page_write_plan`) may be shared by every layer."""
    _require_ported(cfg, kind, use_moe)
    if pages is None:
        raise ValueError("the contiguous cache layout is not ported yet")
    if cache_len.dim() != 1:
        raise ValueError("paged decode requires per-row [B] lens")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_project(p["mixer"], cfg, h, cache_len[:, None])
    if write_plan is None:
        write_plan = attn.page_write_plan(
            pages, cache_len, cache["k"].shape[0], cache["k"].shape[1])
    attn.scatter_planned(cache["k"], write_plan, k[:, 0])
    attn.scatter_planned(cache["v"], write_plan, v[:, 0])
    y = attn.paged_decode_attention(
        p["mixer"], cfg, q, cache["k"], cache["v"], pages, cache_len + 1,
        window=window_for(cfg, kind), impl=attn_impl)
    x = x + attn.attention_out(p["mixer"], y, cfg.num_heads)
    return _ffn(p, x, cfg), cache


def block_prefill_chunk(p, x: torch.Tensor, cache: Dict, cfg, kind: str,
                        use_moe: bool, positions: torch.Tensor,
                        write_pos: torch.Tensor, pages: torch.Tensor,
                        write_plan: Optional[attn.PageWritePlan] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked-prefill pass: C prompt tokens per row. x [B,C,D];
    ``positions`` [B,C] drive rope and the causal mask; ``write_pos``
    [B,C] are where their K/V land — equal to ``positions`` except on
    lanes the engine parks at its drop sentinel. K/V are written before
    attention reads the cache (scatter-then-attend), so the result does
    not depend on how the prompt was chunked."""
    _require_ported(cfg, kind, use_moe)
    if pages is None:
        raise ValueError("the contiguous cache layout is not ported yet")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_project(p["mixer"], cfg, h, positions)
    if write_plan is None:
        write_plan = attn.page_write_plan(
            pages, write_pos, cache["k"].shape[0], cache["k"].shape[1])
    attn.scatter_planned(cache["k"], write_plan, k)
    attn.scatter_planned(cache["v"], write_plan, v)
    y = attn.paged_chunk_attention(
        p["mixer"], cfg, q, cache["k"], cache["v"], pages, positions,
        window=window_for(cfg, kind))
    x = x + attn.attention_out(p["mixer"], y, cfg.num_heads)
    return _ffn(p, x, cfg), cache


def period_layout(cfg):
    """[(kind, use_moe)] for one period, honoring moe.every_n_layers."""
    out = []
    for j, kind in enumerate(cfg.layer_pattern):
        use_moe = False
        if cfg.moe is not None:
            n = cfg.moe.every_n_layers
            use_moe = j % n == n - 1
        out.append((kind, use_moe))
    return out
