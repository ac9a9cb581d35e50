"""GShard-style capacity-based top-k Mixture of Experts (counterpart of
``repro.models.moe``).

Capacity per (batch row, expert) is ``C = ceil(S * k * cf / E)`` over the
row's ``S`` tokens; a token that overflows its expert's buffer is dropped
(GShard semantics) and counted in the aux metrics. Priority is
slot-major then sequence-major: every token's first choice is placed
before any token's second. Routing math is float32 whatever the
activation dtype, and the router weight is float32 whatever the
parameter dtype.

Two semantics are pinned where torch and JAX differ:

* **Ties in the top-k.** ``jax.lax.top_k`` puts the lower index first
  on equal values; ``torch.topk`` promises no order. The selection here
  is a stable descending sort, so a tie routes to the same experts.
* **Out-of-range one-hots and scatters.** ``jax.nn.one_hot`` gives a
  zero row for an index out of range and the reference's index scatter
  drops into a ``cap + 1`` column it slices off. Here every one-hot is a
  comparison (an out-of-range index gives zeros, never an error) and
  only the kept (token, choice) pairs are written.

The einsum (one-hot) dispatch is the default, as in the reference; the
gather dispatch is selected the reference's way, by the environment
variable ``REPRO_MOE_GATHER_DISPATCH``. Neither reaches a Pallas kernel
in the reference, so both are plain torch here.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.act import constrain_expert_model

from .common import spec


def moe_spec(cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.num_experts
    p = {"router": spec((d, e), ("embed", "expert"), dtype=torch.float32),
         "down": spec((e, f, d), ("expert", "mlp", "embed"), dtype=dtype)}
    if cfg.activation == "swiglu":
        p["gate"] = spec((e, d, f), ("expert", "embed", "mlp"), dtype=dtype)
        p["up"] = spec((e, d, f), ("expert", "embed", "mlp"), dtype=dtype)
    else:
        p["in"] = spec((e, d, f), ("expert", "embed", "mlp"), dtype=dtype)
    return p


def capacity(seq: int, num_experts: int, top_k: int, cf: float) -> int:
    return max(1, math.ceil(seq * top_k * cf / num_experts))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot; an index outside [0, n) gives a zero row."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).float()


def _select(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """(probs [B,S,E], renormalised gates [B,S,k], expert ids [B,S,k]);
    ties go to the lower expert id."""
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[..., :top_k], order[..., :top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _slot_positions(onehot: torch.Tensor) -> torch.Tensor:
    """[B,S,k,E] position of each (token, choice) in its expert's buffer:
    slot-major, then sequence-major."""
    counts = torch.zeros(onehot.shape[0], onehot.shape[3],
                         device=onehot.device)
    pos = []
    for slot in range(onehot.shape[2]):
        oh = onehot[:, :, slot]                                 # [B,S,E]
        pos.append(torch.cumsum(oh, dim=1) - oh + counts[:, None, :])
        counts = counts + oh.sum(dim=1)
    return torch.stack(pos, dim=2)


def _aux_loss(probs, onehot, num_experts, top_k):
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = onehot.sum(dim=2).mean(dim=(0, 1))                     # [E]
    return num_experts * torch.sum(me * ce) / max(1, top_k)


def route(x: torch.Tensor, router: torch.Tensor, num_experts: int,
          top_k: int, cap: int):
    """Dispatch and combine tensors. Returns (dispatch [B,S,E,C] 0/1,
    combine [B,S,E,C] float32, aux ``{"moe_aux_loss",
    "moe_drop_frac"}``)."""
    probs, gates, idx = _select(x, router, top_k)
    onehot = _one_hot(idx, num_experts)                         # [B,S,k,E]
    pos = _slot_positions(onehot)
    keep = onehot * (pos < cap)
    # a token reaches each expert through at most one choice
    routed = keep.sum(dim=2)                                    # [B,S,E]
    pos_e = (pos * keep).sum(dim=2)
    gate_e = (gates[..., None] * keep).sum(dim=2)
    dispatch = routed[..., None] * _one_hot(pos_e.to(torch.int32), cap)
    combine = gate_e[..., None] * dispatch
    dropped = 1.0 - keep.sum() / torch.clamp(onehot.sum(), min=1.0)
    return dispatch, combine, {
        "moe_aux_loss": _aux_loss(probs, onehot, num_experts, top_k),
        "moe_drop_frac": dropped}


def route_indices(x: torch.Tensor, router: torch.Tensor, num_experts: int,
                  top_k: int, cap: int):
    """Index-form routing for the gather dispatch. Returns
    ``(token_for_slot [B,E,C] int32`` (S for an empty slot),
    ``gate_for_slot [B,E,C]`` float32, ``slot_for_token [B,S,k] int32``
    (C when dropped), ``expert_for_token [B,S,k]``, the kept gates
    ``[B,S,k]``, aux)."""
    b, s, _ = x.shape
    probs, gates, idx = _select(x, router, top_k)
    onehot = _one_hot(idx, num_experts)
    pos_k = (_slot_positions(onehot) * onehot).sum(dim=-1)      # [B,S,k]
    kept = pos_k < cap
    slot_for_token = torch.where(kept, pos_k,
                                 torch.full_like(pos_k, cap)).to(torch.int32)
    bidx = torch.arange(b, device=x.device)[:, None, None].expand_as(idx)
    sidx = torch.arange(s, device=x.device)[None, :, None].expand_as(idx)
    at = (bidx[kept], idx[kept], slot_for_token[kept].long())
    token_for_slot = torch.full((b, num_experts, cap), s, dtype=torch.int32,
                                device=x.device)
    token_for_slot[at] = sidx[kept].to(torch.int32)
    gate_for_slot = torch.zeros((b, num_experts, cap), dtype=torch.float32,
                                device=x.device)
    gate_for_slot[at] = gates[kept]
    dropped = 1.0 - kept.sum() / kept.numel()
    return (token_for_slot, gate_for_slot, slot_for_token,
            idx.to(torch.int32), gates * kept.float(),
            {"moe_aux_loss": _aux_loss(probs, onehot, num_experts, top_k),
             "moe_drop_frac": dropped})


def _expert_ffn(p, xin: torch.Tensor, cfg) -> torch.Tensor:
    """[E,B,C,D] -> [E,B,C,D] through each expert's FFN."""
    if cfg.activation == "swiglu":
        g = torch.einsum("ebcd,edf->ebcf", xin, p["gate"])
        u = torch.einsum("ebcd,edf->ebcf", xin, p["up"])
        h = F.silu(g) * u
    else:
        h = F.gelu(torch.einsum("ebcd,edf->ebcf", xin, p["in"]),
                   approximate="tanh")
    return torch.einsum("ebcf,efd->ebcd", h, p["down"])


def moe_ffn_einsum(p, x: torch.Tensor, cfg
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-hot einsum (GShard-literal) dispatch and combine. Every expert's
    weights are read whatever the routing: at decode sizes this is the
    layer's cost."""
    mo = cfg.moe
    _, s, _ = x.shape
    cap = capacity(s, mo.num_experts, mo.top_k, mo.capacity_factor)
    dispatch, combine, aux = route(x, p["router"], mo.num_experts,
                                   mo.top_k, cap)
    xin = constrain_expert_model(
        torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x))
    out = constrain_expert_model(_expert_ffn(p, xin, cfg))
    y = torch.einsum("ebcd,bsec->bsd", out, combine.to(x.dtype))
    return y.to(x.dtype), aux


def moe_ffn_gather(p, x: torch.Tensor, cfg
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gather dispatch: tokens move into expert slots by index (empty
    slots read a zero pad row). The combine gathers each token's kept
    expert outputs and sums them with their gates — the reference's
    scatter-add written as a gather, the same sum without a float
    scatter-add's order-dependent atomics on the card."""
    mo = cfg.moe
    b, s, d = x.shape
    cap = capacity(s, mo.num_experts, mo.top_k, mo.capacity_factor)
    token_for_slot, _, slot_for_token, idx, kept_gates, aux = route_indices(
        x, p["router"], mo.num_experts, mo.top_k, cap)
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)        # [B,S+1,D]
    rows = torch.arange(b, device=x.device)
    xin = x_pad[rows[:, None, None], token_for_slot.long()]    # [B,E,C,D]
    xin = constrain_expert_model(xin.permute(1, 0, 2, 3))      # [E,B,C,D]
    out = constrain_expert_model(_expert_ffn(p, xin, cfg))     # [E,B,C,D]
    # a dropped choice (slot C) reads slot 0 with gate 0
    slot = torch.where(slot_for_token < cap, slot_for_token,
                       torch.zeros_like(slot_for_token)).long()
    picked = out[idx.long(), rows[:, None, None], slot]        # [B,S,k,D]
    y = (picked * kept_gates[..., None].to(out.dtype)).sum(dim=2)
    return y.to(x.dtype), aux


def moe_ffn(p, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,D] -> [B,S,D] through the top-k experts: the einsum dispatch
    unless ``REPRO_MOE_GATHER_DISPATCH`` is set."""
    if os.environ.get("REPRO_MOE_GATHER_DISPATCH"):
        return moe_ffn_gather(p, x, cfg)
    return moe_ffn_einsum(p, x, cfg)
