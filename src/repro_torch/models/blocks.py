"""Block wiring: a pre-norm mixer (attention or mamba) + a pre-norm FFN
(dense or MoE), over the full sequence, the contiguous slot cache or the
paged arena (counterpart of ``repro.models.blocks``). A mamba block has
no FFN sublayer when ``d_ff == 0``, and its state ``{"conv", "h"}`` has
no time axis: it stays slot-dense in either layout. While a profiler
records, an attention mixer runs inside a ``model.attention`` range and
a dense FFN inside ``model.ffn`` (an MoE FFN: ``model.moe``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.spans import span

from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from .layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec


def block_spec(cfg, kind: str, use_moe: bool, dtype):
    p = {"ln1": rmsnorm_spec(cfg.d_model),
         "mixer": (mb.mamba_spec(cfg, dtype) if kind == "mamba"
                   else attn.attention_spec(cfg, dtype))}
    if kind != "mamba" or cfg.d_ff > 0:
        p["ln2"] = rmsnorm_spec(cfg.d_model)
        p["ffn"] = (moe_mod.moe_spec(cfg, dtype) if use_moe else
                    mlp_spec(cfg.d_model, cfg.d_ff, cfg.activation, dtype))
    return p


#: why a model with a mamba layer has no chunked prefill
MAMBA_NOT_CHUNKED = ("chunked prefill requires attention layers — mamba "
                     "prefill is recurrent and cannot resume from a KV "
                     "cache")


def window_for(cfg, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _ffn(p, x, cfg, use_moe: bool) -> Tuple[torch.Tensor, Dict]:
    """Pre-norm FFN sublayer with its residual; the MoE aux (``{}`` for a
    dense FFN, or for a mamba block without one)."""
    if "ffn" not in p:
        return x, {}
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        y, aux = moe_mod.moe_ffn(p["ffn"], h, cfg)
        return x + y, aux
    with span("model.ffn"):
        return x + mlp(p["ffn"], h, cfg.activation), {}


def block_forward(p, x: torch.Tensor, cfg, kind: str, use_moe: bool,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, Dict, Dict]:
    """Full-sequence pass (causal). x [B,S,D]; ``positions`` [B,S].
    Returns (x, cache entry, the MoE aux): ``{"k", "v"}`` [B,S,KV,hd]
    for attention, ``{"conv", "h"}`` (the final state) for mamba."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        y, (conv, hs) = mb.mamba_forward(p["mixer"], h, cfg)
        x, aux = _ffn(p, x + y, cfg, use_moe)
        return x, {"conv": conv, "h": hs}, aux
    with span("model.attention"):
        q, k, v = attn.qkv_project(p["mixer"], cfg, h, positions)
        y = attn.full_attention(p["mixer"], cfg, q, k, v, causal=True,
                                window=window_for(cfg, kind))
        x = x + attn.attention_out(p["mixer"], y, cfg.num_heads)
    x, aux = _ffn(p, x, cfg, use_moe)
    return x, {"k": k, "v": v}, aux


WritePlan = Union[attn.PageWritePlan, attn.RowWritePlan]


def block_decode(p, x: torch.Tensor, cache: Dict, cache_len: torch.Tensor,
                 cfg, kind: str, use_moe: bool,
                 pages: Optional[torch.Tensor] = None,
                 attn_impl: str = "gather",
                 write_plan: Optional[WritePlan] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token pass. x [B,1,D]. The new token's K/V is written in place
    at position ``cache_len`` (per row), then attention reads
    ``cache_len + 1`` positions.

    ``pages`` None: the contiguous ``[B, T, KV, hd]`` cache. A ``[B]``
    ``cache_len`` (slot serving) writes row b at ``cache_len[b]``, and a
    row past ``T`` (a retired slot drifting) drops its write; a scalar
    ``cache_len`` (the legacy engine) writes every row at one position,
    clamped into the cache as ``dynamic_update_slice`` does.

    ``pages`` [B,P]: the paged arena; ``cache_len`` must be [B]. Lanes
    past the table or on sentinel pages drop. ``attn_impl`` picks the
    paged read path. ``write_plan`` (from
    :func:`attention.page_write_plan`, or for [B] lengths on the
    contiguous cache :func:`attention.row_write_plan`) may be shared by
    every layer.

    A mamba layer steps its state ``{"conv", "h"}`` (``[B, ...]``, no
    time axis) in place on every row, whatever its length: a frozen or
    retired row's state is scratch until its slot is refilled."""
    cl = torch.as_tensor(cache_len, device=x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        y, (conv, hs) = mb.mamba_decode_step(
            p["mixer"], h, (cache["conv"], cache["h"]), cfg)
        cache["conv"].copy_(conv)
        cache["h"].copy_(hs)
        return _ffn(p, x + y, cfg, use_moe)[0], cache
    with span("model.attention"):
        positions = (cl[:, None] if cl.dim() == 1
                     else cl.reshape(1, 1).expand(x.shape[0], 1))
        q, k, v = attn.qkv_project(p["mixer"], cfg, h, positions)
        if pages is not None:
            if cl.dim() != 1:
                raise ValueError("paged decode requires per-row [B] lens")
            if write_plan is None:
                write_plan = attn.page_write_plan(
                    pages, cl, cache["k"].shape[0], cache["k"].shape[1])
            attn.scatter_planned(cache["k"], write_plan, k[:, 0])
            attn.scatter_planned(cache["v"], write_plan, v[:, 0])
            y = attn.paged_decode_attention(
                p["mixer"], cfg, q, cache["k"], cache["v"], pages, cl + 1,
                window=window_for(cfg, kind), impl=attn_impl)
        else:
            if cl.dim() == 1:
                if write_plan is None:
                    write_plan = attn.row_write_plan(cl, cache["k"].shape[1])
                attn.scatter_rows(cache["k"], write_plan, k)
                attn.scatter_rows(cache["v"], write_plan, v)
            else:
                attn.update_slice(cache["k"], cl, k)
                attn.update_slice(cache["v"], cl, v)
            y = attn.cached_decode_attention(
                p["mixer"], cfg, q, cache["k"], cache["v"], cl + 1,
                window=window_for(cfg, kind))
        x = x + attn.attention_out(p["mixer"], y, cfg.num_heads)
    return _ffn(p, x, cfg, use_moe)[0], cache


def block_prefill_chunk(p, x: torch.Tensor, cache: Dict, cfg, kind: str,
                        use_moe: bool, positions: torch.Tensor,
                        write_pos: torch.Tensor,
                        pages: Optional[torch.Tensor] = None,
                        write_plan: Optional[WritePlan] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked-prefill pass: C prompt tokens per row. x [B,C,D];
    ``positions`` [B,C] drive rope and the causal mask; ``write_pos``
    [B,C] are where their K/V land — equal to ``positions`` except on
    lanes the engine parks at its drop sentinel, which write nothing in
    either layout (``pages`` None: the contiguous cache). K/V are
    written before attention reads the cache (scatter-then-attend), so
    the result does not depend on how the prompt was chunked.

    Attention layers only: a mamba prefill is recurrent and cannot
    resume from a cache, so the engine never chunks a model that has
    one."""
    if kind == "mamba":
        raise ValueError(MAMBA_NOT_CHUNKED)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    with span("model.attention"):
        q, k, v = attn.qkv_project(p["mixer"], cfg, h, positions)
        window = window_for(cfg, kind)
        if pages is None:
            if write_plan is None:
                write_plan = attn.row_write_plan(write_pos,
                                                 cache["k"].shape[1])
            attn.scatter_rows(cache["k"], write_plan, k)
            attn.scatter_rows(cache["v"], write_plan, v)
            y = attn.cached_chunk_attention(
                p["mixer"], cfg, q, cache["k"], cache["v"], positions,
                window=window)
        else:
            if write_plan is None:
                write_plan = attn.page_write_plan(
                    pages, write_pos, cache["k"].shape[0],
                    cache["k"].shape[1])
            attn.scatter_planned(cache["k"], write_plan, k)
            attn.scatter_planned(cache["v"], write_plan, v)
            y = attn.paged_chunk_attention(
                p["mixer"], cfg, q, cache["k"], cache["v"], pages,
                positions, window=window)
        x = x + attn.attention_out(p["mixer"], y, cfg.num_heads)
    return _ffn(p, x, cfg, use_moe)[0], cache


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
