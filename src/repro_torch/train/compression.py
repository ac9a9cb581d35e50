"""int8 error-feedback gradient compression (counterpart of
``repro.train.compression``).

* ``quantize_int8`` — per-tensor symmetric int8 (scale = max|g| / 127);
* feedback — the quantization residual is carried to the next step and
  added back, so the accumulated error stays bounded;
* ``compressed_psum_approx`` — what an update sees under compression,
  with no transport (the one-card form).

The reference's ``compressed_allreduce_int8`` moves int8 shards between
the devices of a mesh; it has no one-card form and raises here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import tree_map

Tree = Dict[str, Any]


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar) with ``q * scale ~ g``."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(q, scale, new residual) of ``g + residual``; g and residual
    float32."""
    corrected = g + residual
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_allreduce_int8(v: torch.Tensor, mesh=None, axis: str = "data"
                              ) -> torch.Tensor:
    """The reference's int8 all-to-all / all-gather sum over a mesh axis:
    not ported, since it needs several devices."""
    raise NotImplementedError("compressed_allreduce_int8 is not ported: "
                              "needs several devices")


def compressed_psum_approx(g: torch.Tensor) -> torch.Tensor:
    """Quantize and dequantize: what the update sees under compression."""
    q, scale = quantize_int8(g.float())
    return dequantize_int8(q, scale).to(g.dtype)


def make_feedback_state(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def apply_compression(grads: Tree, feedback: Tree) -> Tuple[Tree, Tree]:
    """Tree-wise error-feedback quantization: (the gradients as the
    update sees them, in their dtypes; the new residuals)."""
    def one(g, r):
        q, s, nr = compress_with_feedback(g.float(), r)
        return dequantize_int8(q, s).to(g.dtype), nr

    res = tree_map(one, grads, feedback)
    return (tree_map(lambda x: x[0], res), tree_map(lambda x: x[1], res))
