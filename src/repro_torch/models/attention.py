"""GQA attention on the paged KV arena: the serving main path's functions
(counterpart of ``repro.models.attention``).

On one card the reference's head plan is always ``"shard"`` (tensor
parallelism 1), so query heads are never padded: ``attention_out`` and
the fused adapter check ``Hq == num_heads``. GQA is handled by
*expanding* K/V to one head per query head (kv-major: query head ``h``
reads kv head ``h // G``).

The paged cache is one ``[num_pages, page_size, KV, hd]`` arena per
layer and k/v, shared by all rows, plus a per-row block table ``[B, P]``
of page ids; an entry ``>= num_pages`` is a sentinel (unallocated or
masked for the round). Page ``j`` of a row covers flat positions
``[j*ps, (j+1)*ps)``.

Two semantics differ from JAX and are handled here:

* **Writes.** JAX scatters with ``mode="drop"``: a write addressed past
  the table or into a sentinel page vanishes, and the engine relies on
  it (its ``_DROP_POS`` write sentinel, sentinel table rows). Torch
  indexing raises on such an index (or asserts on the device). So every
  scatter first selects its live lanes with a boolean mask
  (:func:`page_write_plan`) and writes only those — masked lanes are
  never clamped onto a live cell. Writes update the arena **in place**
  (the JAX functions return a new arena; the port saves the copy).
* **Reads.** The gather path clips sentinel pages to the last page, as
  the reference does; the rows that only read such pages are garbage
  and are never read by the engine (the fused kernel gives zeros).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.paged_attention import paged_decode_fused

from .common import spec
from .layers import head_rmsnorm, head_rmsnorm_spec, rope

NEG_INF = -2.0e38


def attention_spec(cfg, dtype):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": spec((d, h, hd), dtype),
        "wk": spec((d, kv, hd), dtype),
        "wv": spec((d, kv, hd), dtype),
        "wo": spec((h, hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((h, hd), dtype, init="zeros")
        p["bk"] = spec((kv, hd), dtype, init="zeros")
        p["bv"] = spec((kv, hd), dtype, init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = head_rmsnorm_spec(hd)
        p["k_norm"] = head_rmsnorm_spec(hd)
    return p


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,T,KV,hd] -> [B,T,H,hd]: one K/V head per query head."""
    b, t, kvh, hd = kv.shape
    g = n_heads // kvh
    if g == 1:
        return kv
    return kv[:, :, :, None, :].expand(b, t, kvh, g, hd).reshape(
        b, t, kvh * g, hd)


# -------------------------------------------------------------- projection
def qkv_project(p, cfg, x: torch.Tensor, positions: Optional[torch.Tensor]):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd] (qk-norm, then rope)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(p, y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """y [B,S,H,hd] -> [B,S,D]."""
    if p["wo"].shape[0] != n_heads:
        raise ValueError(f"wo has {p['wo'].shape[0]} heads, the model "
                         f"{n_heads}: head padding has no use on one card")
    return torch.einsum("bshk,hkd->bsd", y, p["wo"])


# -------------------------------------------------------------- paged I/O
def gather_pages(arena: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """[num_pages, ps, ...] arena + [B, P] table -> [B, P*ps, ...] per-row
    view in position order. Sentinel entries clip to the last page; what
    they read lies past the row's length and is masked downstream."""
    num_pages = arena.shape[0]
    g = arena[pages.long().clamp(0, num_pages - 1)]
    b, p_cap, ps = g.shape[:3]
    return g.reshape((b, p_cap * ps) + tuple(g.shape[3:]))


class PageWritePlan(NamedTuple):
    """Where the live lanes of a paged write land: ``lanes`` index the
    written values, ``page``/``offset`` the arena cell of each."""
    lanes: tuple
    page: torch.Tensor
    offset: torch.Tensor


def page_write_plan(pages: torch.Tensor, pos: torch.Tensor,
                    num_pages: int, page_size: int) -> PageWritePlan:
    """Plan a write of one value per ``pos`` entry (``pos`` [B] or
    [B, C], flat positions of row b's paged cache). Lanes whose position
    lies outside the block table (the engine's ``_DROP_POS`` sentinel in
    particular) or whose table entry is a sentinel page are left out —
    the masked form of the reference's ``mode="drop"``. The plan depends
    only on the table and the positions, so one plan serves every layer
    and both k and v."""
    p_cap = pages.shape[1]
    pos2 = pos.long() if pos.dim() == 2 else pos.long()[:, None]
    page_idx = torch.div(pos2, page_size, rounding_mode="floor")
    in_table = (page_idx >= 0) & (page_idx < p_cap)
    page = torch.gather(pages.long(), 1, page_idx.clamp(0, p_cap - 1))
    live = in_table & (page >= 0) & (page < num_pages)
    if pos.dim() == 1:
        live, page, pos2 = live[:, 0], page[:, 0], pos2[:, 0]
    lanes = torch.nonzero(live, as_tuple=True)
    return PageWritePlan(lanes, page[lanes],
                         torch.remainder(pos2, page_size)[lanes])


def scatter_planned(arena: torch.Tensor, plan: PageWritePlan,
                    val: torch.Tensor) -> torch.Tensor:
    """Write ``val`` (indexed like the plan's positions, trailing dims
    as the arena's) at the plan's live lanes, in place. Returns the
    arena."""
    arena[plan.page, plan.offset] = val[plan.lanes].to(arena.dtype)
    return arena


def scatter_page_token(arena: torch.Tensor, pages: torch.Tensor,
                       pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write ``val[b]`` at flat position ``pos[b]`` of row b's paged
    cache, in place. arena [num_pages, ps, ...]; pages [B, P]; pos [B];
    val [B, ...]. Writes past the table or into sentinel pages drop."""
    plan = page_write_plan(pages, pos, arena.shape[0], arena.shape[1])
    return scatter_planned(arena, plan, val)


def scatter_page_tokens(arena: torch.Tensor, pages: torch.Tensor,
                        pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Chunk form: write ``val[b, c]`` at flat position ``pos[b, c]``, in
    place. pos [B, C]; val [B, C, ...]. Within one chunk the engine feeds
    strictly increasing positions per row, so no two live lanes alias."""
    plan = page_write_plan(pages, pos, arena.shape[0], arena.shape[1])
    return scatter_planned(arena, plan, val)


# ------------------------------------------------------------------ decode
def _lengths(cache_len, b: int, device) -> torch.Tensor:
    cl = torch.as_tensor(cache_len, device=device)
    return cl[:, None] if cl.dim() == 1 else cl.reshape(1, 1).expand(b, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over the (expanded) cache. q [B,1,H,hd];
    caches [B,T,H,hd]; positions ``< cache_len`` (and within the window)
    are attended."""
    b, _, h, hd = q.shape
    t = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqhd,bthd->bqht", q * scale, k_cache).float()
    pos = torch.arange(t, device=q.device)
    cl = _lengths(cache_len, b, q.device)
    valid = pos[None, :] < cl
    if window is not None:
        valid &= pos[None, :] >= cl - window
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqht,bthd->bqhd", p.to(v_cache.dtype), v_cache)
    return out.to(q.dtype)


def chunk_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, q_positions: torch.Tensor,
                           *, window: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill attention: the query at absolute position p
    attends cache positions ``<= p`` (its own K/V was scattered before
    this read). q [B,C,H,hd]; q_positions [B,C]."""
    b, c, h, hd = q.shape
    t = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqhd,bthd->bqht", q * scale, k_cache).float()
    pos = torch.arange(t, device=q.device)
    qp = q_positions.long()
    valid = pos[None, None, :] <= qp[:, :, None]                 # [B, C, T]
    if window is not None:
        valid &= pos[None, None, :] > qp[:, :, None] - window
    sc = torch.where(valid[:, :, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqht,bthd->bqhd", p.to(v_cache.dtype), v_cache)
    return out.to(q.dtype)


def cached_decode_attention(p, cfg, q, k_cache, v_cache, cache_len, *,
                            window: Optional[int]) -> torch.Tensor:
    h = cfg.num_heads
    return decode_attention(q, expand_kv(k_cache, h), expand_kv(v_cache, h),
                            cache_len, window=window)


def cached_chunk_attention(p, cfg, q, k_cache, v_cache, q_positions, *,
                           window: Optional[int]) -> torch.Tensor:
    h = cfg.num_heads
    return chunk_decode_attention(q, expand_kv(k_cache, h),
                                  expand_kv(v_cache, h), q_positions,
                                  window=window)


def paged_decode_attention(p, cfg, q, k_arena, v_arena, pages, cache_len, *,
                           window: Optional[int],
                           impl: str = "gather") -> torch.Tensor:
    """Block-table decode. ``impl="gather"``: gather each row's pages
    into position order, then attend as the contiguous layout does.
    ``impl="fused"``: the fused paged-decode kernel walks the table per
    (row, kv head) in one pass (CUDA on the card; its plain version on
    the CPU)."""
    if impl == "fused":
        return paged_decode_fused(q, k_arena, v_arena, pages, cache_len,
                                  cfg.num_heads, window=window)
    if impl != "gather":
        raise ValueError(f"unknown paged decode impl {impl!r}; "
                         f"expected 'gather' or 'fused'")
    return cached_decode_attention(p, cfg, q, gather_pages(k_arena, pages),
                                   gather_pages(v_arena, pages), cache_len,
                                   window=window)


def paged_chunk_attention(p, cfg, q, k_arena, v_arena, pages, q_positions, *,
                          window: Optional[int]) -> torch.Tensor:
    """Block-table chunked prefill: gather, then attend at each query's
    absolute position."""
    return cached_chunk_attention(p, cfg, q, gather_pages(k_arena, pages),
                                  gather_pages(v_arena, pages), q_positions,
                                  window=window)
