"""Norms, RoPE, embeddings and the dense FFN (counterpart of
``repro.models.layers``). Every function takes and returns tensors of
the reference's layouts and computes in the reference's precisions."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.act import (constrain_batch, is_distributed,
                                     vocab_parallel_log_prob)

from .common import activation, spec


# ------------------------------------------------------------------- norms
def rmsnorm_spec(d: int):
    return {"scale": spec((d,), ("embed",), dtype=torch.float32, init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def head_rmsnorm_spec(hd: int, axis: str = "head_dim"):
    return {"scale": spec((hd,), (axis,), dtype=torch.float32,
                          init="ones")}


def head_rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing head_dim (qwen3 qk-norm)."""
    return rmsnorm(p, x, eps)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-split layout, angles in float32.
    x: [..., S, H, hd]; positions: [..., S]."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=x.device), -freq)        # [half]
    ang = positions[..., None].float() * inv                # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- embeddings
def embedding_spec(vocab: int, d: int, dtype):
    return {"tokens": spec((vocab, d), ("vocab", "embed"), dtype=dtype)}


def embed(p, token_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table (``F.embedding``: on a vocab-sharded ``DTensor``
    table each device looks up its own rows and the partial rows are
    summed, where indexing would gather the whole table)."""
    return F.embedding(token_ids.long(), p["tokens"])


_UNEMBED_ROWS = 16384   # vocab rows cast to float32 at a time


def unembed(p_embed, p_head, x: torch.Tensor, *, tie: bool) -> torch.Tensor:
    """Project to float32 vocab logits (tied or separate head). A
    low-precision weight is upcast a block of vocab rows at a time, so a
    151k-row bf16 embedding never needs a whole float32 copy."""
    xf = x.float()
    w = p_embed["tokens"] if tie else p_head["kernel"].t()       # [V, d]
    if w.dtype == torch.float32 or is_distributed(w):
        # a vocab-sharded weight is cast on its shards: blocking its
        # rows would gather them
        return torch.einsum("bsd,vd->bsv", xf, w.float())
    out = torch.empty(x.shape[:-1] + (w.shape[0],), dtype=torch.float32,
                      device=x.device)
    for v0 in range(0, w.shape[0], _UNEMBED_ROWS):
        out[..., v0:v0 + _UNEMBED_ROWS] = torch.einsum(
            "bsd,vd->bsv", xf, w[v0:v0 + _UNEMBED_ROWS].float())
    return out


def label_log_probs(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """``log_softmax(logits)[..., labels]``: [..., V] logits, [...]
    label ids. A ``DTensor`` split on the vocabulary takes the
    vocabulary-parallel form (``sharding.act.vocab_parallel_log_prob``:
    two small all-reduces, where the plain form would gather every
    logit)."""
    if is_distributed(logits):
        return vocab_parallel_log_prob(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def lm_head_spec(d: int, vocab: int, dtype):
    return {"kernel": spec((d, vocab), ("embed", "vocab"), dtype=dtype)}


# --------------------------------------------------------------------- ffn
GATED = ("swiglu", "geglu")


def mlp_spec(d: int, f: int, act: str, dtype):
    if act in GATED:
        return {"gate": spec((d, f), ("embed", "mlp"), dtype=dtype),
                "up": spec((d, f), ("embed", "mlp"), dtype=dtype),
                "down": spec((f, d), ("mlp", "embed"), dtype=dtype)}
    return {"in": spec((d, f), ("embed", "mlp"), dtype=dtype),
            "out": spec((f, d), ("mlp", "embed"), dtype=dtype)}


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act in GATED:
        g = torch.einsum("bsd,df->bsf", x, p["gate"])
        u = torch.einsum("bsd,df->bsf", x, p["up"])
        a = activation("silu" if act == "swiglu" else "gelu")
        return constrain_batch(
            torch.einsum("bsf,fd->bsd", a(g) * u, p["down"]))
    h = activation(act)(torch.einsum("bsd,df->bsf", x, p["in"]))
    return constrain_batch(torch.einsum("bsf,fd->bsd", h, p["out"]))
