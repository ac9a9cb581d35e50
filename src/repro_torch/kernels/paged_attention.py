"""Fused paged-decode attention: CUDA kernel, plain version, model adapter.

Counterpart of ``repro.kernels.paged_attention`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/paged_decode.cu``; its header says
what bounds it on the H100 and how it is laid out.

* :func:`paged_decode` — ``[B, KV, G, hd]`` queries against the paged
  arena ``[num_pages, ps, KV, hd]`` through a ``[B, P]`` block table.
  A CUDA tensor launches the kernel; a CPU tensor takes the plain
  version. There is no fallback: a CUDA call that cannot launch, or a
  shape the kernel does not take, raises.
* :func:`plan_splits` / :func:`split_ranges` — how the kernel cuts each
  (row, kv head) over its table entries, chosen on the host from the
  shapes, the SM count and the CTAs per SM of the variant
  (:func:`ctas_per_sm`) alone (never the lengths).
* :func:`paged_decode_plain` — gather-then-attend in torch, in the
  kernel's grouping: sentinel *pages* are masked as the kernel masks
  them and rows with no live lane are exact zeros (the counterpart of
  ``ref.py::paged_decode_ref``).
* :func:`paged_decode_split_model` — the kernel's split and
  log-sum-exp merge in torch, which the tests hold to the JAX kernel.
* :func:`paged_decode_fused` — the decode path's ``[B, 1, H, hd]`` ↔
  ``[B, KV, G, hd]`` adapter (counterpart of ``ops.py``). Under the
  ``'pad'`` head plan only the model's heads reach the kernel; the
  padded ones come back as zeros.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import CudaKernel

NEG_INF = -2.0e38

_P, _I = ctypes.c_void_p, ctypes.c_int
PAGED_DECODE = CudaKernel(
    "paged_decode.cu", "paged_decode_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, ctypes.c_float, _I, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 128, 256)
MAX_GROUPS = 8
# CTAs per SM the split aims at (two fit at hd 128 in bf16: ~100 KB of
# shared memory each), and the most splits one (row, kv head) may take.
CTAS_PER_SM = 2
MAX_SPLITS = 256
# Shared memory of one H100 SM, and what the runtime reserves per CTA.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_CTA = 1024


def ctas_per_sm(head_dim: int, dtype: torch.dtype) -> int:
    """CTAs of the kernel's (dtype, head_dim) variant that one SM holds by
    shared memory, at most CTAS_PER_SM. Mirrors ``Cfg`` in the source: a
    ring of 4 warps x NS stages x K and V of a 16-position tile, NS 3
    while a stage is at most 8 KB, 2 up to 16 KB, else 1; 4 KB of
    scores; the per-warp partials when they are larger. bf16 hd 128
    gets 2, bf16 and fp32 at hd 256 (and fp32 at hd 128) get 1."""
    el = 4 if dtype == torch.float32 else 2
    stage = 2 * 16 * head_dim * el
    ns = 3 if stage <= 8192 else 2 if stage <= 16384 else 1
    ring = 4 * ns * stage
    warp_parts = 4 * (MAX_GROUPS * head_dim + 2 * MAX_GROUPS) * 4
    per_cta = (max(ring, warp_parts) + 4 * 2 * 16 * MAX_GROUPS * 4
               + SMEM_RESERVED_PER_CTA)
    return max(1, min(CTAS_PER_SM, SMEM_PER_SM // per_cta))


def plan_splits(table_width: int, batch: int, kv_heads: int,
                sm_count: int, ctas_per_sm: int = CTAS_PER_SM):
    """``(splits, pages_per_split)`` for a ``[batch, table_width]`` block
    table: as many splits of each (row, kv head) as fill ``ctas_per_sm``
    CTAs on every SM in one wave, never more than the table has entries.
    It reads no length, so the host never waits on the card."""
    if table_width <= 0:
        return 1, 1
    rows = max(1, batch * kv_heads)
    splits = max(1, (ctas_per_sm * sm_count) // rows)
    splits = min(splits, table_width, MAX_SPLITS)
    pps = -(-table_width // splits)
    return -(-table_width // pps), pps


def split_ranges(table_width: int, pages_per_split: int):
    """Table entries ``[j0, j1)`` of each split, in split order."""
    return [(j0, min(j0 + pages_per_split, table_width))
            for j0 in range(0, table_width, pages_per_split)]


_SM_COUNT: dict = {}
_COUNTERS: dict = {}


def sm_count(device: torch.device) -> int:
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device.index]


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The per-(row, kv head) arrival counters of one stream: zeroed once
    when made (or grown); the kernel leaves them at zero."""
    buf = _COUNTERS.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[(device.index, stream)] = buf
    return buf


def _check(q, k_arena, v_arena, pages, cache_len):
    if q.dim() != 4 or k_arena.dim() != 4 or v_arena.shape != k_arena.shape:
        raise ValueError(f"expected q [B,KV,G,hd] and arenas "
                         f"[num_pages,ps,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_arena.shape)}, {tuple(v_arena.shape)}")
    b, kv, _, hd = q.shape
    if k_arena.shape[2] != kv or k_arena.shape[3] != hd:
        raise ValueError(f"arena heads/width {tuple(k_arena.shape[2:])} do "
                         f"not match q {(kv, hd)}")
    if (pages.dim() != 2 or pages.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError(f"expected pages [B,P] and cache_len [B] for B={b}; "
                         f"got {tuple(pages.shape)}, {tuple(cache_len.shape)}")
    devs = {t.device for t in (q, k_arena, v_arena, pages, cache_len)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode inputs span devices {devs}")


def paged_decode(q: torch.Tensor, k_arena: torch.Tensor,
                 v_arena: torch.Tensor, pages: torch.Tensor,
                 cache_len: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """One-pass block-table decode attention. Returns ``[B, KV, G, hd]``
    in ``q``'s dtype. ``pages`` entries ``>= num_pages`` are sentinels;
    a negative entry reads page 0."""
    _check(q, k_arena, v_arena, pages, cache_len)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_arena, v_arena, pages, cache_len,
                                  window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda or cpu, not {q.device}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise TypeError(f"paged_decode takes float32 or bfloat16 q and "
                        f"arenas of one dtype; got {q.dtype}, "
                        f"{k_arena.dtype}, {v_arena.dtype}")
    if pages.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise TypeError("pages and cache_len must be int32")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("pages", pages), ("cache_len", cache_len)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode needs a contiguous {name}")
    b, kv, g, hd = q.shape
    if hd not in HEAD_DIMS or g > MAX_GROUPS:
        raise ValueError(f"the paged-decode kernel takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUPS} query heads "
                         f"per kv head; got hd={hd}, G={g}")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode needs {name} 16-byte aligned")
    num_pages, ps = k_arena.shape[0], k_arena.shape[1]
    p_cap = pages.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        splits, pps = plan_splits(p_cap, b, kv, sm_count(q.device),
                                  ctas_per_sm(hd, q.dtype))
        ws = torch.empty(b * kv * splits * g * (2 + hd) if splits > 1 else 1,
                         dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, b * kv)
        PAGED_DECODE.launch(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            pages.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), b, kv, g, hd, num_pages, ps,
            p_cap, pps, splits, -1 if window is None else int(window),
            1.0 / math.sqrt(hd), dtype, stream)
    return out


def paged_decode_plain(q: torch.Tensor, k_arena: torch.Tensor,
                       v_arena: torch.Tensor, pages: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Gather-then-attend in the kernel's ``[B, KV, G, hd]`` grouping,
    fp32 throughout. Sentinel pages are masked whole and all-masked rows
    give exact zeros, so it is comparable with the kernel on every row."""
    b, kv, g, hd = q.shape
    num_pages, ps = k_arena.shape[0], k_arena.shape[1]
    p_cap = pages.shape[1]
    idx = pages.long().clamp(0, num_pages - 1)
    kb = k_arena[idx].reshape(b, p_cap * ps, kv, hd).float()
    vb = v_arena[idx].reshape(b, p_cap * ps, kv, hd).float()
    pos = torch.arange(p_cap * ps, device=q.device)
    cl = cache_len.long()[:, None]
    valid = pos[None, :] < cl                                     # [B, T]
    if window is not None:
        valid &= pos[None, :] >= cl - window
    valid &= (pages < num_pages).repeat_interleave(ps, dim=1)
    sc = torch.einsum("bhgd,bthd->bhgt", q.float() * (1.0 / math.sqrt(hd)), kb)
    mask = valid[:, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgt,bthd->bhgd", p, vb) / l.clamp_min(1e-37)
    return out.to(q.dtype)


def paged_decode_split_model(q: torch.Tensor, k_arena: torch.Tensor,
                             v_arena: torch.Tensor, pages: torch.Tensor,
                             cache_len: torch.Tensor, *,
                             pages_per_split: int,
                             window: Optional[int] = None) -> torch.Tensor:
    """The CUDA kernel's decomposition written in torch, for the tests
    and ``chip_smoke.py`` only: each split of ``pages_per_split`` table
    entries gives an unnormalised partial ``(m, l, acc)`` (an empty split
    has ``m = NEG_INF``, ``l = 0``), then the partials are merged by
    log-sum-exp in split order, skipping empty ones. fp32 throughout."""
    b, kv, g, hd = q.shape
    num_pages, ps = k_arena.shape[0], k_arena.shape[1]
    p_cap = pages.shape[1]
    idx = pages.long().clamp(0, num_pages - 1)
    kb = k_arena[idx].reshape(b, p_cap * ps, kv, hd).float()
    vb = v_arena[idx].reshape(b, p_cap * ps, kv, hd).float()
    pos = torch.arange(p_cap * ps, device=q.device)
    cl = cache_len.long()[:, None]
    valid = pos[None, :] < cl
    if window is not None:
        valid &= pos[None, :] >= cl - window
    valid &= (pages < num_pages).repeat_interleave(ps, dim=1)
    qs = q.float() * (1.0 / math.sqrt(hd))
    parts = []
    for j0, j1 in split_ranges(p_cap, pages_per_split):
        sl = slice(j0 * ps, j1 * ps)
        mask = valid[:, None, None, sl]
        sc = torch.einsum("bhgd,bthd->bhgt", qs, kb[:, sl])
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(dim=-1)
        p = torch.where(mask, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhgt,bthd->bhgd", p, vb[:, sl])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_tot = torch.zeros_like(m_all)
    acc = torch.zeros(b, kv, g, hd, dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        w = torch.where(l > 0, torch.exp(m - m_all), torch.zeros_like(m))
        l_tot = l_tot + l * w
        acc = acc + a * w[..., None]
    return (acc / l_tot.clamp_min(1e-37)[..., None]).to(q.dtype)


def paged_decode_fused(q: torch.Tensor, k_arena: torch.Tensor,
                       v_arena: torch.Tensor, pages: torch.Tensor,
                       cache_len: torch.Tensor, n_heads: int, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Decode-path adapter: ``q [B, 1, Hq, hd]`` → ``[B, 1, Hq, hd]``
    (``Hq >= n_heads`` under the ``'pad'`` head plan). Query head ``h``
    reads kv head ``h // G`` (the kv-major grouping of ``expand_kv``), so
    the model's heads reshape directly to ``[B, KV, G, hd]``; padded
    heads never reach the kernel and come back as zeros."""
    b, s, hq, hd = q.shape
    if s != 1:
        raise ValueError("fused paged decode is single-token (q [B,1,H,hd])")
    kv = k_arena.shape[2]
    if n_heads % kv:
        raise ValueError(f"num_heads {n_heads} not divisible by "
                         f"num_kv_heads {kv}")
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if cl.dim() == 0:
        cl = cl.expand(b)
    qg = q[:, 0, :n_heads].reshape(b, kv, n_heads // kv, hd).contiguous()
    out = paged_decode(qg, k_arena, v_arena,
                       pages.to(torch.int32).contiguous(), cl.contiguous(),
                       window=window).reshape(b, 1, n_heads, hd)
    if hq > n_heads:
        out = torch.nn.functional.pad(out, (0, 0, 0, hq - n_heads))
    return out
