"""The yardstick's arithmetic: the chip's peaks, the model's operations per
token, and the bytes the paged decode kernel has to move. Nothing here
reads the program; it works from the configuration file's sizes.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity,
at 700 W), the constants of ``repro_torch/analysis/roofline.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

PEAK_FLOPS = 989e12      # bf16 tensor cores
HBM_BW = 3.35e12         # bytes/s


def active_params(dm: Dict[str, Any]) -> int:
    """Weights one token multiplies by: every layer's attention and FFN
    (an MoE layer: its router and its top-k experts) and the
    unembedding. The input embedding is a lookup and is left out."""
    d, h, kv, hd, ff = dm["d"], dm["heads"], dm["kv_heads"], dm["hd"], dm["ff"]
    attn = d * (h + 2 * kv) * hd + h * hd * d
    if dm["experts"]:
        ffn = d * dm["experts"] + dm["top_k"] * 3 * d * ff
    elif dm["activation"] == "swiglu":
        ffn = 3 * d * ff
    else:
        ffn = 2 * d * ff
    return dm["layers"] * (attn + ffn) + d * dm["vocab"]


def token_flops(dm: Dict[str, Any], context: int) -> float:
    """Useful operations of one token at a position that attends
    ``context`` positions (itself included): ``2 x`` the active weights,
    plus ``QK^T`` and ``PV`` over the context in every layer."""
    return (2.0 * active_params(dm)
            + 4.0 * dm["layers"] * dm["heads"] * dm["hd"] * context)


def span_flops(dm: Dict[str, Any], p0: int, p1: int) -> float:
    """``token_flops`` summed over the positions ``[p0, p1)``, each
    attending every position up to itself."""
    n = max(int(p1) - int(p0), 0)
    ctx = n * (int(p0) + 1 + int(p1)) / 2.0     # sum of p + 1
    return (2.0 * active_params(dm) * n
            + 4.0 * dm["layers"] * dm["heads"] * dm["hd"] * ctx)


def decode_bytes(dm: Dict[str, Any], lengths: Iterable[int]) -> float:
    """Bytes one decode step's attention needs over every layer: for each
    row, the K and V of each position it attends (``lengths``: positions
    per row, the new token's included), its query and its output, read
    or written once, in the served dtype (2 bytes)."""
    kv_row = 2 * dm["kv_heads"] * dm["hd"] * 2
    qo_row = 2 * dm["heads"] * dm["hd"] * 2
    total = sum(int(n) * kv_row + qo_row for n in lengths)
    return float(dm["layers"] * total)
