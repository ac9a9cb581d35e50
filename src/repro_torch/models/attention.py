"""GQA attention: tensor-parallel head planning, full-sequence prefill,
and decode over the contiguous slot cache or the paged KV arena
(counterpart of ``repro.models.attention``).

Head plans, chosen per (head count, tensor-parallel degree) by
:func:`head_plan`; the degree is the active activation policy's
``'model'`` size (``sharding/act.py``; 1, plan ``'shard'``, when unset):

  'shard'  heads % tp == 0: heads as they are.
  'pad'    pad query heads to the next tp multiple when that costs at
           most 1.5x (qwen3 40 -> 48 at tp 16). ``attention_spec`` stores
           the padded ``wq``/``wo``; ``attention_out`` masks the rows of
           ``wo`` past the model's heads, so the padded heads add exactly
           nothing; K/V are padded with zero heads to match.
  'seq'    too few heads to pad (gemma3's 4 at tp 16): heads replicated,
           the sequence dimension of the scores sharded instead —
           :func:`kv_chunked_attention`, or :func:`banded_attention` for
           causal sliding-window layers.

GQA is handled by *expanding* K/V to one head per query head (kv-major:
query head ``h`` reads kv head ``h // G``).

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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import paged_decode_fused
from repro_torch.sharding.act import constrain_seq_model, current_tp

from .common import spec
from .layers import head_rmsnorm, head_rmsnorm_spec, rope

NEG_INF = -2.0e38


def attention_spec(cfg, dtype):
    """Parameter spec. Under a ``'pad'`` head plan ``wq``/``wo`` (and
    ``bq``) hold ``hp`` (tp-aligned) heads; the extra rows are masked at
    apply time (:func:`attention_out`). The plan is read from the active
    activation policy, so specs built for a mesh and for one card are
    each self-consistent."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    plan, hp = head_plan(h)
    hq = hp if plan == "pad" else h
    p = {
        "wq": spec((d, hq, hd), ("embed", "heads", "head_dim"), dtype=dtype),
        "wk": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   dtype=dtype),
        "wv": spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                   dtype=dtype),
        "wo": spec((hq, hd, d), ("heads", "head_dim", "embed"), dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((hq, hd), ("heads", "head_dim"), dtype=dtype,
                       init="zeros")
        p["bk"] = spec((kv, hd), ("kv_heads", "head_dim"), dtype=dtype,
                       init="zeros")
        p["bv"] = spec((kv, hd), ("kv_heads", "head_dim"), dtype=dtype,
                       init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = head_rmsnorm_spec(hd)
        p["k_norm"] = head_rmsnorm_spec(hd)
    return p


# ---------------------------------------------------------------- planning
def head_plan(n_heads: int, tp: Optional[int] = None) -> Tuple[str, int]:
    """(plan, padded heads) for this head count under tp-way sharding."""
    tp = tp if tp is not None else current_tp()
    if tp <= 1 or n_heads % tp == 0:
        return "shard", n_heads
    padded = -(-n_heads // tp) * tp
    if padded <= 1.5 * n_heads:
        return "pad", padded
    return "seq", n_heads


def expand_kv(kv: torch.Tensor, n_heads: int, pad_to: int = 0
              ) -> torch.Tensor:
    """[B,T,KV,hd] -> [B,T,H(p),hd]: one K/V head per query head, then
    zero heads up to ``pad_to``."""
    b, t, kvh, hd = kv.shape
    g = n_heads // kvh
    out = kv if g == 1 else kv[:, :, :, None, :].expand(
        b, t, kvh, g, hd).reshape(b, t, kvh * g, hd)
    return pad_heads(out, pad_to)


def pad_heads(q: torch.Tensor, pad_to: int) -> torch.Tensor:
    """Zero heads appended on dim 2 up to ``pad_to``."""
    h = q.shape[2]
    if pad_to <= h:
        return q
    return F.pad(q, (0, 0, 0, pad_to - h))


def _pick_chunk(s: int, target: int = 1024) -> int:
    c = min(s, target)
    while s % c:
        c -= 1
    return c


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
    """y [B,S,Hq,hd] -> [B,S,D]. When the projection is head-padded, the
    rows ``>= n_heads`` of ``wo`` are masked to zero, so the padded heads
    contribute exactly nothing."""
    wo = p["wo"]
    hq = wo.shape[0]
    if hq > n_heads:
        mask = (torch.arange(hq, device=wo.device) < n_heads).to(wo.dtype)
        wo = wo * mask[:, None, None]
    return torch.einsum("bshk,hkd->bsd", y, wo)


# ----------------------------------------------------- full-sequence paths
def _pair_list(nq: int, nk: int, cq: int, ck: int, causal: bool,
               window: Optional[int]):
    """Static (q_block, kv_block) schedule: only blocks that can attend."""
    pairs = []
    for qi in range(nq):
        if causal:
            hi = qi + 1
            lo = 0
            if window is not None:
                lo = max(0, (qi * cq - window + 1) // ck)
            lo = min(lo, hi)
        else:
            lo, hi = 0, nk
        for j in range(lo, hi):
            pairs.append((qi, j))
    return pairs


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention over the static block schedule of
    :func:`_pair_list` (exact triangle / window work): the reference's
    ``lax.scan`` over the pairs as a Python loop, with the same float32
    running max, sum and accumulator per query block (plain torch
    matmuls, as the reference leaves them to XLA). q [B,S,H,hd];
    k, v [B,T,H,hd] (already expanded). Returns [B,S,H,hd]."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    cq = _pick_chunk(s, q_chunk)
    ck = _pick_chunk(t, kv_chunk)
    nq, nk = s // cq, t // ck
    scale = 1.0 / math.sqrt(hd)
    qs = q * scale
    dev = q.device
    iota_q = torch.arange(cq, device=dev)
    iota_k = torch.arange(ck, device=dev)
    m = [torch.full((b, cq, h), NEG_INF, dtype=torch.float32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((b, cq, h), dtype=torch.float32, device=dev)
         for _ in range(nq)]
    acc = [torch.zeros((b, cq, h, hd), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    for qi, j in _pair_list(nq, nk, cq, ck, causal, window):
        qb = qs[:, qi * cq:(qi + 1) * cq]
        # the reference's dynamic_slice clamps the start into the keys
        # (a causal pair past the last key block when cq < ck); the mask
        # below keeps the unclamped positions, so such a block adds 0
        k0 = min(j * ck, t - ck)
        kc = k[:, k0:k0 + ck]
        vc = v[:, k0:k0 + ck]
        sc = torch.einsum("bqhd,bchd->bqhc", qb, kc).float()
        if causal:
            qpos = qi * cq + iota_q
            kpos = j * ck + iota_k
            ok = kpos[None, :] <= qpos[:, None]
            if window is not None:
                ok &= kpos[None, :] > qpos[:, None] - window
            sc = torch.where(ok[None, :, None, :], sc,
                             torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m[qi], sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m[qi] - m_new)
        l[qi] = l[qi] * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype), vc)
        acc[qi] = acc[qi] * alpha[..., None] + pv.float()
        m[qi] = m_new
    out = torch.cat([a / torch.clamp(li[..., None], min=1e-37)
                     for a, li in zip(acc, l)], dim=1)
    return out.to(q.dtype)


def kv_chunked_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool,
                         kv_chunk: int = 1024) -> torch.Tensor:
    """Online softmax over kv chunks with the whole query resident — the
    sequence dim stays intact, so an activation constraint can shard it
    over the model axis (the ``'seq'`` plan). Rectangle work when causal.
    q [B,S,H,hd]; k, v [B,T,H,hd] (expanded). Returns [B,S,H,hd]."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    ck = _pick_chunk(t, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qs = constrain_seq_model(q * scale)
    qpos = torch.arange(s, device=dev)
    iota_k = torch.arange(ck, device=dev)
    m = constrain_seq_model(torch.full((b, s, h), NEG_INF,
                                       dtype=torch.float32, device=dev))
    l = constrain_seq_model(torch.zeros((b, s, h), dtype=torch.float32,
                                        device=dev))
    acc = constrain_seq_model(torch.zeros((b, s, h, hd),
                                          dtype=torch.float32, device=dev))
    for j in range(t // ck):
        kc = k[:, j * ck:(j + 1) * ck]
        vc = v[:, j * ck:(j + 1) * ck]
        sc = torch.einsum("bqhd,bchd->bqhc", qs, kc).float()
        if causal:
            ok = (j * ck + iota_k)[None, :] <= qpos[:, None]
            sc = torch.where(ok[None, :, None, :], sc,
                             torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = constrain_seq_model(l * alpha + p.sum(dim=-1))
        pv = torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype), vc)
        acc = constrain_seq_model(acc * alpha[..., None] + pv.float())
        m = constrain_seq_model(m_new)
    return (acc / torch.clamp(l[..., None], min=1e-37)).to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int) -> torch.Tensor:
    """Exact causal sliding-window attention through a gathered [S, W]
    band of K/V — O(S*W) work and memory, seq-shardable (local layers
    under the ``'seq'`` plan). q, k, v [B,S,H,hd] (expanded)."""
    b, s, h, hd = q.shape
    w = min(window, s)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    band = pos[:, None] - (w - 1) + torch.arange(w, device=q.device)[None]
    valid = band >= 0                                         # [S, W]
    band_c = band.clamp(0, s - 1)
    kb = k[:, band_c]                                         # [B,S,W,H,hd]
    vb = v[:, band_c]
    qs = constrain_seq_model(q * scale)
    sc = torch.einsum("bqhd,bqwhd->bqhw", qs, kb).float()
    sc = torch.where(valid[None, :, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqhw,bqwhd->bqhd", p.to(v.dtype), vb)
    return out.to(q.dtype)


def full_attention(p, cfg, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """Full-sequence attention, [B,S,Hq,hd] before ``wo``, on the path
    of the head plan. ``q`` comes from the (possibly head-padded)
    projection, so ``q.shape[2]`` is already tp-aligned under ``'pad'``."""
    h = cfg.num_heads
    plan, _ = head_plan(h)
    hq = q.shape[2]
    if plan in ("shard", "pad"):
        return blocked_attention(q, expand_kv(k, h, pad_to=hq),
                                 expand_kv(v, h, pad_to=hq),
                                 causal=causal, window=window)
    # 'seq' plan: replicated heads, sequence-sharded scores
    ke, ve = expand_kv(k, h), expand_kv(v, h)
    if window is not None and causal:
        return banded_attention(q, ke, ve, window=window)
    return kv_chunked_attention(q, ke, ve, causal=causal)


# ------------------------------------------------------- contiguous writes
class RowWritePlan(NamedTuple):
    """Where the live lanes of a contiguous-cache write land: ``rows``
    and ``lanes`` index the written values, ``pos`` the time position
    of each in its row."""
    rows: torch.Tensor
    lanes: torch.Tensor
    pos: torch.Tensor


def row_write_plan(pos: torch.Tensor, max_len: int) -> RowWritePlan:
    """Plan a write of one value per ``pos`` entry (``pos`` [B] or
    [B, C], time positions in row b of a contiguous ``[B, max_len, ...]``
    cache). Positions outside ``[0, max_len)`` are left out — the
    masked form of the reference's ``.at[rows, pos].set(...,
    mode="drop")``: a retired slot drifting past ``max_len`` and the
    engine's ``_DROP_POS`` lanes write nothing. The plan depends only on
    the positions, so one plan serves every layer and both k and v."""
    pos2 = pos.long() if pos.dim() == 2 else pos.long()[:, None]
    live = (pos2 >= 0) & (pos2 < max_len)
    rows, lanes = torch.nonzero(live, as_tuple=True)
    return RowWritePlan(rows, lanes, pos2[rows, lanes])


def scatter_rows(cache: torch.Tensor, plan: RowWritePlan,
                 val: torch.Tensor) -> torch.Tensor:
    """Write ``val[b, c]`` ([B, C, ...]; C = 1 for a decode step) at the
    plan's live lanes of the contiguous cache, in place. Returns the
    cache."""
    cache[plan.rows, plan.pos] = val[plan.rows, plan.lanes].to(cache.dtype)
    return cache


def update_slice(cache: torch.Tensor, start: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(cache, val, start, axis=1)`` in
    place: the start is clamped so the update fits (at ``start >= T - S``
    the last ``S`` positions are overwritten; nothing drops). ``start``
    stays on the device, so the write needs no host round trip. Returns
    the cache."""
    s, t = val.shape[1], cache.shape[1]
    t0 = torch.clamp(torch.as_tensor(start, device=cache.device).long(),
                     0, t - s)
    idx = t0.reshape(1) + torch.arange(s, device=cache.device)
    return cache.index_copy_(1, idx, val.to(cache.dtype))


# -------------------------------------------------------------- paged I/O
def gather_pages(arena: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """[num_pages, ps, ...] arena + [B, P] table -> [B, P*ps, ...] per-row
    view in position order. Sentinel entries clip to the last page; what
    they read lies past the row's length and is masked downstream."""
    num_pages = arena.shape[0]
    g = arena[pages.long().clamp(0, num_pages - 1)]
    b, p_cap, ps = g.shape[:3]
    return g.reshape((b, p_cap * ps) + tuple(g.shape[3:]))


def page_copy_ids(src, dst, num_pages: int, device) -> Optional[torch.Tensor]:
    """Host half of :func:`copy_pages`: the ``[2, n]`` int64 (src, dst)
    lanes that copy, on ``device``, uploaded in one transfer — or None
    when no lane copies. ``src``/``dst`` are host ids (numpy or CPU
    tensors). A lane whose ``dst`` is a sentinel (outside ``[0,
    num_pages)``) drops, as the reference's scatter drops it; a live
    lane must read a page of the arena, and no two live lanes may write
    one page (``index_copy_`` leaves duplicates undefined; the split
    plan never makes one)."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
    live = (dst >= 0) & (dst < num_pages)
    src, dst = src[live], dst[live]
    if not dst.size:
        return None
    assert ((src >= 0) & (src < num_pages)).all(), \
        f"copy from a page outside the arena [0, {num_pages}): {src}"
    assert np.unique(dst).size == dst.size, f"duplicate copy target: {dst}"
    return torch.from_numpy(np.stack([src, dst])).to(device)


def copy_planned(arena: torch.Tensor, ids: Optional[torch.Tensor],
                 axis: int = 0) -> torch.Tensor:
    """Copy pages ``ids[0, i] -> ids[1, i]`` along the arena's page axis
    ``axis``, in place (one gather and one scatter for every layer a
    period-stacked leaf holds). Source and target pages never overlap:
    the targets are fresh grants. Returns the arena."""
    if ids is not None:
        arena.index_copy_(axis, ids[1], arena.index_select(axis, ids[0]))
    return arena


def copy_pages(arena: torch.Tensor, src, dst, axis: int = 0) -> torch.Tensor:
    """Copy whole pages ``src[i] -> dst[i]`` within one arena, in place —
    the device half of a copy-on-write split. arena ``[..., num_pages,
    ps, ...]`` with the page axis at ``axis``; src/dst ``[n]`` host ids.
    Stream order puts the copy before the next dispatch that reads the
    repointed table, so nobody sees a half-copied page."""
    return copy_planned(
        arena, page_copy_ids(src, dst, arena.shape[axis], arena.device),
        axis)


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
    h, hq = cfg.num_heads, q.shape[2]
    return decode_attention(q, expand_kv(k_cache, h, pad_to=hq),
                            expand_kv(v_cache, h, pad_to=hq), cache_len,
                            window=window)


def cached_chunk_attention(p, cfg, q, k_cache, v_cache, q_positions, *,
                           window: Optional[int]) -> torch.Tensor:
    h, hq = cfg.num_heads, q.shape[2]
    return chunk_decode_attention(q, expand_kv(k_cache, h, pad_to=hq),
                                  expand_kv(v_cache, h, pad_to=hq),
                                  q_positions, window=window)


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


def naive_reference_attention(q, k, v, *, causal: bool,
                              window: Optional[int] = None) -> torch.Tensor:
    """O(S^2)-memory GQA oracle used only by tests. q [B,S,H,hd];
    k, v [B,T,KV,hd]."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    ke, ve = expand_kv(k, h), expand_kv(v, h)
    sc = torch.einsum("bqhd,bthd->bqht", q, ke).float() / math.sqrt(hd)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        sc = torch.where(ok[None, :, None, :], sc,
                         torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqht,bthd->bqhd", p.to(v.dtype), ve)
    return out.to(q.dtype)
