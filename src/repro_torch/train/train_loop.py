"""Train-step and serve-step builders: microbatching and remat
(counterpart of ``repro.train.train_loop``).

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss's gradients by autograd, accumulated in
float32 over ``num_microbatches`` equal splits of the batch's leading
axis (the activation-memory knob), an optional ``grad_transform`` hook
on the averaged gradients (where compression plugs in), then one AdamW
update. Per-period rematerialization is the model's ``remat`` flag, so
prefill and decode never recompute. The reference's multi-device
gradient reductions have no counterpart on one card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import optimizer as opt

Tree = Dict[str, Any]


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The batch as ``n`` equal consecutive splits of its leading axis."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"microbatches {n}")
    return [{k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _unflatten(like: Tree, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(like)


def value_and_grad(loss_fn: Callable, params: Tree, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` with
    respect to every parameter leaf; ``params`` is left as it was (the
    leaves are differentiated through detached aliases)."""
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_leaves(params)]
    live = _unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _unflatten(params, grads)


def make_loss_fn(model, *, remat: bool = True) -> Callable:
    """The model's ``loss_fn`` with its remat flag set (the flag lives on
    the model so the serving paths stay remat-free)."""
    model.remat = remat
    return model.loss_fn


def make_train_step(model, opt_cfg: opt.AdamWConfig, *,
                    num_microbatches: int = 1, remat: bool = True,
                    grad_transform: Optional[Callable[[Tree], Tree]] = None):
    """Build the train step. With several microbatches the gradients
    accumulate in float32 in microbatch order and are averaged, the loss
    is the microbatch mean, and the other metrics are the last
    microbatch's. ``grad_transform`` post-processes the gradients."""
    loss_fn = make_loss_fn(model, remat=remat)

    def train_step(params: Tree, opt_state: opt.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        if num_microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            g_acc, l_acc = None, None
            for mb in _split_microbatches(batch, num_microbatches):
                (l, metrics), g = value_and_grad(loss_fn, params, mb)
                g = tree_map(lambda x: x.float(), g)
                g_acc = g if g_acc is None else tree_map(
                    lambda a, b: a + b, g_acc, g)
                l_acc = l if l_acc is None else l_acc + l
            grads = tree_map(lambda g: g / num_microbatches, g_acc)
            metrics = dict(metrics)
            metrics["loss"] = l_acc / num_microbatches
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_state, om = opt.update(opt_cfg, grads, opt_state,
                                               params)
        metrics.update(om)
        return new_params, new_state, metrics

    return train_step


def make_serve_step(model):
    """``(params, cache, token) -> (logits, cache)``: one decode step."""
    def serve_step(params, cache, token):
        return model.decode_step(params, cache, token)
    return serve_step


def make_prefill_step(model, max_len: Optional[int] = None):
    """``(params, batch) -> (logits, cache)``; the encoder-decoder sizes
    its self cache from its config, as the reference's does."""
    def prefill_step(params, batch):
        if model.cfg.is_encdec:
            return model.prefill(params, batch)
        return model.prefill(params, batch, max_len=max_len)
    return prefill_step
