"""Mamba-1 (selective SSM) block: chunked prefill scan and the one-token
decode step (counterpart of ``repro.models.mamba``).

The selective scan ``h_t = dA_t * h_{t-1} + dB_t x_t`` expands the state
to ``[B, d_inner, N]`` per token. Prefill runs an outer loop over time
*chunks* (carrying ``h``) with one of two inner scans: ``sequential``
(the default: one step per token, ``dA``/``dBx`` made on the fly, only
``h`` live) or ``associative`` (log-depth over the chunk, materializing
the ``[B, L, DI, N]`` expansion). Decode is the recurrence itself. A
layer's state is ``(conv_tail [B, cw-1, DI], h [B, DI, N] float32)``.

Precisions are the reference's: projections and the convolution in the
model dtype, the scan, ``dt`` and the skip term in float32; ``A_log``,
``D`` and ``dt_bias`` are float32 leaves in any model dtype.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import spec


def _dims(cfg):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    cw = cfg.ssm.conv_width
    dtr = cfg.ssm.dt_rank or max(1, math.ceil(d / 16))
    return d, di, n, cw, dtr


def mamba_spec(cfg, dtype):
    d, di, n, cw, dtr = _dims(cfg)
    return {
        "in_proj": spec((d, 2 * di), ("embed", "mlp"), dtype=dtype),
        "conv_w": spec((cw, di), ("conv", "mlp"), dtype=dtype),
        "conv_b": spec((di,), ("mlp",), dtype=dtype, init="zeros"),
        "x_proj": spec((di, dtr + 2 * n), ("mlp", "dt"), dtype=dtype),
        "dt_proj": spec((dtr, di), ("dt", "mlp"), dtype=dtype),
        "dt_bias": spec((di,), ("mlp",), dtype=torch.float32,
                        init="zeros"),
        "A_log": spec((di, n), ("mlp", "state"), dtype=torch.float32,
                      init="ones"),
        "D": spec((di,), ("mlp",), dtype=torch.float32, init="ones"),
        "out_proj": spec((di, d), ("mlp", "embed"), dtype=dtype),
    }


def _ssm_inputs(p, x: torch.Tensor, cfg):
    """The input projection. x [B,S,D] -> (x1, z) [B,S,DI] each."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    x1, z = torch.chunk(xz, 2, dim=-1)
    return x1, z


def _post_conv(p, x1c: torch.Tensor, cfg):
    """silu, then the data-dependent ``dt`` [B,S,DI] and ``B``/``C``
    [B,S,N] (float32)."""
    _, _, n, _, dtr = _dims(cfg)
    x1c = F.silu(x1c)
    bcdt = torch.einsum("bse,ef->bsf", x1c, p["x_proj"])
    dt_low = bcdt[..., :dtr]
    bs = bcdt[..., dtr:dtr + n].float()
    cs = bcdt[..., dtr + n:].float()
    dt = torch.einsum("bsr,re->bse", dt_low, p["dt_proj"]).float()
    dt = F.softplus(dt + p["dt_bias"])
    return x1c, dt, bs, cs


def _causal_conv(p, x1: torch.Tensor, cfg,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time. x1 [B,S,DI]; ``tail``
    [B,cw-1,DI] (decode) continues a sequence, else it starts from
    zeros."""
    cw = _dims(cfg)[3]
    pad = (x1.new_zeros((x1.shape[0], cw - 1, x1.shape[2])) if tail is None
           else tail.to(x1.dtype))
    xp = torch.cat([pad, x1], dim=1)                     # [B,S+cw-1,DI]
    s = x1.shape[1]
    out = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    return out + p["conv_b"]


def _chunk_scan_associative(dA: torch.Tensor, dBx: torch.Tensor,
                            h0: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``
    over the chunk's time axis, in log2(L) Hillis-Steele rounds, carrying
    ``h0`` in. dA, dBx [B,L,DI,N] float32. Returns (h_all, h_last)."""
    aA, aB = dA, dBx
    d = 1
    while d < aA.shape[1]:
        cur_a, cur_b = aA[:, d:], aB[:, d:]
        aB = torch.cat([aB[:, :d], aB[:, :-d] * cur_a + cur_b], dim=1)
        aA = torch.cat([aA[:, :d], aA[:, :-d] * cur_a], dim=1)
        d *= 2
    h_all = aA * h0[:, None] + aB
    return h_all, h_all[:, -1]


def _chunk_scan_sequential(dtc: torch.Tensor, bsc: torch.Tensor,
                           csc: torch.Tensor, xc: torch.Tensor,
                           A: torch.Tensor, h0: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step per token of the chunk: ``dA``/``dBx`` [B,DI,N] are made
    on the fly and only ``h`` stays live. dtc, xc [B,L,DI]; bsc, csc
    [B,L,N]; A [DI,N]. Returns (y_chunk [B,L,DI], h_last)."""
    h, ys = h0, []
    for t in range(dtc.shape[1]):
        dt_t, bs_t, cs_t, x_t = dtc[:, t], bsc[:, t], csc[:, t], xc[:, t]
        dA = torch.exp(dt_t[..., None] * A)
        dBx = (dt_t * x_t)[..., None] * bs_t[:, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("ben,bn->be", h, cs_t))
    return torch.stack(ys, dim=1), h


#: the within-chunk scan unless ``inner`` or ``REPRO_MAMBA_INNER`` says
DEFAULT_INNER = "sequential"


def mamba_forward(p, x: torch.Tensor, cfg, *, chunk: int = 128,
                  inner: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill pass. x [B,S,D] -> (y [B,S,D], (conv_tail [B,cw-1,DI],
    h [B,DI,N])). The chunk length is the largest divisor of S not above
    ``chunk``; ``inner`` is ``"sequential"`` or ``"associative"``."""
    inner = inner or os.environ.get("REPRO_MAMBA_INNER", DEFAULT_INNER)
    if inner not in ("sequential", "associative"):
        raise ValueError(f"unknown inner scan {inner!r}; expected "
                         f"sequential or associative")
    b, s, _ = x.shape
    _, di, n, cw, _ = _dims(cfg)
    lc = min(chunk, s)
    while s % lc:
        lc -= 1

    x1, z = _ssm_inputs(p, x, cfg)
    x1c, dt, bs, cs = _post_conv(p, _causal_conv(p, x1, cfg), cfg)
    A = -torch.exp(p["A_log"])                           # [DI,N]
    x1f = x1c.float()

    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, lc):
        dtc, bsc, csc, xc = (t[:, t0:t0 + lc] for t in (dt, bs, cs, x1f))
        if inner == "associative":
            dA = torch.exp(dtc[..., None] * A)                # [B,L,DI,N]
            dBx = (dtc * xc)[..., None] * bsc[:, :, None, :]
            h_all, h = _chunk_scan_associative(dA, dBx, h)
            ys.append(torch.einsum("blen,bln->ble", h_all, csc))
        else:
            yc, h = _chunk_scan_sequential(dtc, bsc, csc, xc, A, h)
            ys.append(yc)
    y = torch.cat(ys, dim=1) + p["D"] * x1f              # [B,S,DI]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])

    if s >= cw - 1:
        conv_tail = x1[:, s - (cw - 1):]
    else:
        conv_tail = torch.cat(
            [x1.new_zeros((b, cw - 1 - s, di)), x1], dim=1)
    return out, (conv_tail, h)


def mamba_decode_step(p, x: torch.Tensor,
                      state: Tuple[torch.Tensor, torch.Tensor], cfg
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """One-token step. x [B,1,D]; ``state`` (conv_tail [B,cw-1,DI],
    h [B,DI,N]). Returns (y [B,1,D], the new state)."""
    conv_tail, h = state
    x1, z = _ssm_inputs(p, x, cfg)                       # [B,1,DI]
    x1c, dt, bs, cs = _post_conv(
        p, _causal_conv(p, x1, cfg, tail=conv_tail), cfg)
    A = -torch.exp(p["A_log"])
    xf = x1c[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)                # [B,DI,N]
    dBx = (dt[:, 0] * xf)[..., None] * bs[:, 0, None, :]
    h_new = dA * h + dBx
    y = torch.einsum("ben,bn->be", h_new, cs[:, 0]) + p["D"] * xf
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    new_tail = torch.cat([conv_tail[:, 1:], x1.to(conv_tail.dtype)], dim=1)
    return out, (new_tail, h_new)


def mamba_state_shape(cfg, batch: int):
    """((conv_tail shape), (h shape)) of one layer's decode state."""
    _, di, n, cw, _ = _dims(cfg)
    return ((batch, cw - 1, di), (batch, di, n))
