"""Fused paged-decode attention: CUDA kernel, plain version, model adapter.

Counterpart of ``repro.kernels.paged_attention`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/paged_decode.cu``; its header says
what bounds it on the H100 and how it is laid out.

* :func:`paged_decode` — ``[B, KV, G, hd]`` queries against the paged
  arena ``[num_pages, ps, KV, hd]`` through a ``[B, P]`` block table.
  A CUDA tensor launches the kernel; a CPU tensor takes the plain
  version. There is no fallback: a CUDA call that cannot launch raises.
* :func:`paged_decode_plain` — gather-then-attend in torch, in the
  kernel's grouping: sentinel *pages* are masked as the kernel masks
  them and rows with no live lane are exact zeros (the counterpart of
  ``ref.py::paged_decode_ref``).
* :func:`paged_decode_fused` — the decode path's ``[B, 1, H, hd]`` ↔
  ``[B, KV, G, hd]`` adapter (counterpart of ``ops.py``). On one card
  the head plan is always "shard", so there are no padded heads.
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
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    in ``q``'s dtype. ``pages`` entries ``>= num_pages`` are sentinels."""
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
    num_pages, ps = k_arena.shape[0], k_arena.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        PAGED_DECODE.launch(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            pages.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            b, kv, g, hd, num_pages, ps, pages.shape[1],
            -1 if window is None else int(window),
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


def paged_decode_fused(q: torch.Tensor, k_arena: torch.Tensor,
                       v_arena: torch.Tensor, pages: torch.Tensor,
                       cache_len: torch.Tensor, n_heads: int, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Decode-path adapter: ``q [B, 1, H, hd]`` → ``[B, 1, H, hd]``.
    Query head ``h`` reads kv head ``h // G`` (the kv-major grouping of
    ``expand_kv``), so the heads reshape directly to ``[B, KV, G, hd]``."""
    b, s, hq, hd = q.shape
    if s != 1:
        raise ValueError("fused paged decode is single-token (q [B,1,H,hd])")
    if hq != n_heads:
        raise ValueError(f"q carries {hq} heads, the model {n_heads}: head "
                         f"padding has no use on one card")
    kv = k_arena.shape[2]
    if n_heads % kv:
        raise ValueError(f"num_heads {n_heads} not divisible by "
                         f"num_kv_heads {kv}")
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if cl.dim() == 0:
        cl = cl.expand(b)
    qg = q[:, 0].reshape(b, kv, n_heads // kv, hd).contiguous()
    out = paged_decode(qg, k_arena, v_arena,
                       pages.to(torch.int32).contiguous(), cl.contiguous(),
                       window=window)
    return out.reshape(b, 1, n_heads, hd)
