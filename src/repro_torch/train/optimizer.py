"""AdamW with a warmup-cosine schedule, global-norm clipping and float32
state (counterpart of ``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of tensors with the
parameter tree's paths. Every update runs in float32 and is cast back to
the parameter's dtype; the moments are float32 (the first one in
``momentum_dtype``); weight decay is decoupled and applies to matrices
only. ``factored_second_moment`` keeps an Adafactor-style rank-1 second
moment (a row and a column vector over the trailing two dims) for every
leaf whose trailing dims are both at least 16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import sorted_leaves, tree_leaves, tree_map

Tree = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # memory knobs: a factored second moment (rank-1 over the trailing two
    # dims) and a reduced-precision first moment
    factored_second_moment: bool = False
    momentum_dtype: str = "float32"


class AdamWState(NamedTuple):
    count: torch.Tensor       # int32 scalar: updates applied
    m: Tree
    v: Tree                   # a leaf, or {"row", "col"} when factored


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup to ``peak_lr``, then a
    cosine down to ``min_lr_ratio * peak_lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _is_factored(cfg: AdamWConfig, shape) -> bool:
    return (cfg.factored_second_moment and len(shape) >= 2
            and shape[-1] >= 16 and shape[-2] >= 16)


def init(cfg: AdamWConfig, params: Tree) -> AdamWState:
    """Zero moments on each parameter's device."""
    mdtype = _DTYPES[cfg.momentum_dtype]

    def mk_v(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _is_factored(cfg, p.shape):
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return torch.zeros(p.shape, **f32)

    device = next(leaf for _, leaf in tree_leaves(params)).device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=mdtype,
                                         device=p.device), params),
        v=tree_map(mk_v, params))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's order (keys sorted), so the norm does not
    depend on the order a tree's dicts were built in."""
    total = None
    for _, g in sorted_leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree
           ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, ``{"grad_norm",
    "lr"}``). Nothing is modified in place."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=cf.device), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=cf.device), cf)
    mdtype = _DTYPES[cfg.momentum_dtype]

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        if isinstance(v, dict):          # factored second moment
            g2 = torch.square(g) + 1e-30
            row = cfg.b2 * v["row"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
            col = cfg.b2 * v["col"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
            v_new = {"row": row, "col": col}
            vhat = (row[..., None] * col[..., None, :]
                    / torch.clamp(torch.mean(row, dim=-1,
                                             keepdim=True)[..., None],
                                  min=1e-30))
            vhat = vhat / b2c
        else:
            v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            vhat = v_new / b2c
        mhat = m_new / b1c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                 # decoupled decay, matrices only
            step = step + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        return new_p, m_new.to(mdtype), v_new

    # a factored leaf's {"row", "col"} moment reaches upd whole: the walk
    # follows the gradient tree, whose leaf is there
    res = tree_map(upd, grads, state.m, state.v, params)
    new_p, new_m, new_v = (tree_map(lambda r, i=i: r[i], res)
                           for i in range(3))
    return (new_p, AdamWState(count=count, m=new_m, v=new_v),
            {"grad_norm": gnorm, "lr": lr})
