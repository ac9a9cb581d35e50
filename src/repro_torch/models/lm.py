"""Decoder-only language model — dense, MoE, pure SSM and hybrid —
inference paths (counterpart of ``repro.models.lm.LM``).

Parameters keep the reference's tree: ``embed/tokens``,
``periods/layer_<j>/...`` stacked over the periods on a leading axis,
``leftover/layer_<j>/...`` for remainder layers, ``final_norm``, and
``lm_head`` when embeddings are untied. The reference scans over the
stacked periods; here a Python loop indexes the leading axis. The cache
mirrors the reference's cache tree, in one of two layouts, updated in
place by the layers:

* contiguous — ``periods/layer_<j>/k`` is ``[n_periods, B, max_len, KV,
  hd]`` (one row per slot or sequence) plus ``len``: a scalar (the
  legacy engine, every row at one depth) or a ``[B]`` vector (slot
  serving);
* paged — ``[n_periods, num_pages, ps, KV, hd]`` arenas plus the
  engine-owned ``len`` [B] vector and ``pages`` [B, P] block table.

A mamba layer's entry is its recurrent state ``{conv, h}`` in either
layout: one row per slot or sequence, no time axis.

A stub-frontend model (``cfg.frontend``: the VLM) has no ``embed`` leaf
and always an ``lm_head``; it reads precomputed embeddings
(``batch["embeds"]`` [B,S,D], and a ``[B,D]`` "next embed stub" per
decode step) where a token model reads ids.

Ported: ``forward``, ``loss_fn`` (with per-period rematerialization when
``remat`` is set), one-shot ``prefill`` (with and without ``length=``),
``init_cache``, ``prefill_chunk`` and ``decode_step``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.spans import span
from repro_torch.sharding.act import checkpoint_contexts, constrain_batch

from . import attention as attn
from . import blocks
from .common import init_params, stack_specs, tree_map
from .layers import (embed, embedding_spec, label_log_probs, lm_head_spec,
                     rmsnorm, rmsnorm_spec, unembed)
from .mamba import mamba_state_shape

Tree = Dict[str, Any]

#: the cache leaves with a time axis (an attention layer's); the paged
#: layout pages them, and every other leaf (a mamba layer's state) keeps
#: one row per sequence
TIME_LEAVES = ("k", "v")


class LM:
    def __init__(self, cfg):
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with models.build_model (EncDecLM)")
        self.cfg = cfg
        self.n_periods, self.pattern, self.leftover = cfg.periods()
        self.layout = blocks.period_layout(cfg)
        # Per-period rematerialization for the loss: the train step
        # turns it on; prefill and decode never recompute.
        self.remat = False

    def _remat_group(self) -> int:
        """Periods per outer checkpoint of the two-level (sqrt-N) remat;
        1 = flat, one checkpoint per period (below 16 periods, or with
        ``REPRO_FLAT_REMAT`` set)."""
        if os.environ.get("REPRO_FLAT_REMAT"):
            return 1
        np_ = self.n_periods
        if np_ < 16:
            return 1
        g = 1
        for d in range(2, int(np_ ** 0.5) + 1):
            if np_ % d == 0:
                g = d
        return g

    # ----------------------------------------------------------- param spec
    def spec_tree(self) -> Tree:
        cfg = self.cfg
        dtype = cfg.dtype
        period = {f"layer_{j}": blocks.block_spec(cfg, kind, use_moe, dtype)
                  for j, (kind, use_moe) in enumerate(self.layout)}
        tree: Tree = {"periods": stack_specs(period, self.n_periods),
                      "final_norm": rmsnorm_spec(cfg.d_model)}
        if self.leftover:
            tree["leftover"] = {
                f"layer_{j}": blocks.block_spec(cfg, kind, use_moe, dtype)
                for j, (kind, use_moe)
                in enumerate(self.layout[:len(self.leftover)])}
        if cfg.frontend is None:
            tree["embed"] = embedding_spec(cfg.vocab_size, cfg.d_model,
                                           dtype)
            if not cfg.tie_embeddings:
                tree["lm_head"] = lm_head_spec(cfg.d_model, cfg.vocab_size,
                                               dtype)
        else:
            # stub frontend: embeddings come in precomputed; the head
            # still projects to the vocabulary
            tree["lm_head"] = lm_head_spec(cfg.d_model, cfg.vocab_size, dtype)
        return tree

    def init(self, generator: torch.Generator, device) -> Tree:
        """Random weights drawn from ``generator`` on ``device``."""
        return init_params(self.spec_tree(), generator, device)

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int, device,
                   state_batch: Optional[int] = None) -> Tree:
        """Zero cache tree plus ``len``: per attention layer ``{k, v}``
        of shape ``[n_periods, batch_size, max_len, KV, hd]``, per mamba
        layer ``{conv [n_periods, B, cw-1, DI] (model dtype), h
        [n_periods, B, DI, N] (float32)}`` with ``B = state_batch``
        (default ``batch_size``); leftover layers without the leading
        axis. With ``batch_size = num_pages``, ``max_len = page_size``
        and ``state_batch`` the slot count, the k/v leaves are exactly
        the paged arenas and the mamba state stays slot-dense
        (serve.kv_pages.PagedSlotPool)."""
        cfg = self.cfg
        sb = batch_size if state_batch is None else state_batch

        def entry(kind, lead):
            if kind == "mamba":
                cshape, hshape = mamba_state_shape(cfg, sb)
                shapes = {"conv": (cshape, cfg.dtype),
                          "h": (hshape, torch.float32)}
            else:
                kv = ((batch_size, max_len, cfg.num_kv_heads,
                       cfg.resolved_head_dim), cfg.dtype)
                shapes = {"k": kv, "v": kv}
            return {n: torch.zeros(lead + shape, dtype=dt, device=device)
                    for n, (shape, dt) in shapes.items()}

        return {
            "periods": {f"layer_{j}": entry(kind, (self.n_periods,))
                        for j, (kind, _) in enumerate(self.layout)},
            "leftover": {f"layer_{j}": entry(self.layout[j][0], ())
                         for j in range(len(self.leftover))},
            "len": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _layers(self, params: Tree, cache: Tree
                ) -> Iterator[Tuple[Tree, Tree, str, bool]]:
        """(layer params, layer cache, kind, use_moe) in depth order."""
        for i in range(self.n_periods):
            for j, (kind, use_moe) in enumerate(self.layout):
                name = f"layer_{j}"
                yield (tree_map(lambda a: a[i], params["periods"][name]),
                       tree_map(lambda a: a[i], cache["periods"][name]),
                       kind, use_moe)
        for j in range(len(self.leftover)):
            kind, use_moe = self.layout[j]
            name = f"layer_{j}"
            yield (params["leftover"][name], cache["leftover"][name],
                   kind, use_moe)

    def _arena_shape(self, cache: Tree) -> Optional[Tuple[int, int]]:
        """(num_pages, page_size) of a paged arena, (B, max_len) of a
        contiguous cache; None when no layer is attention."""
        for group in ("periods", "leftover"):
            for entry in cache[group].values():
                if TIME_LEAVES[0] in entry:
                    return entry["k"].shape[-4], entry["k"].shape[-3]
        return None

    def _embed(self, params: Tree, tokens: torch.Tensor) -> torch.Tensor:
        x = embed(params["embed"], tokens).to(self.cfg.dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return constrain_batch(x)

    def _embed_in(self, params: Tree, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        """The sequence input [B,S,D]: token embeddings, or the stub
        frontend's precomputed ``batch["embeds"]``."""
        if self.cfg.frontend is None:
            return self._embed(params, batch["tokens"])
        return constrain_batch(batch["embeds"].to(self.cfg.dtype))

    def _unembed(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        with span("model.unembed"):
            if self.cfg.frontend is None and self.cfg.tie_embeddings:
                return unembed(params["embed"], None, x, tie=True)
            return unembed(None, params["lm_head"], x, tie=False)

    # ------------------------------------------------------------- forward
    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward over ``batch["tokens"]`` [B,S] (or the
        stub frontend's ``batch["embeds"]`` [B,S,D]). Returns (logits
        [B,S,V], aux): for an MoE model ``moe_aux_loss`` and
        ``moe_drop_frac`` summed over every MoE layer (per period, then
        over periods, then the leftover layers, the reference's order);
        ``{}`` otherwise."""
        x, _, aux = self._backbone(params, batch, want_cache=False)
        return self._unembed(params, x), aux

    def _period(self, params: Tree, i: int, x: torch.Tensor,
                positions: torch.Tensor, keys: Tuple[str, ...]):
        """Period ``i``'s layers. Returns (x, caches, the period's MoE aux
        summed from zero in layer order)."""
        cfg = self.cfg
        aux_sum = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                   for k in keys}
        caches = {}
        for j, (kind, use_moe) in enumerate(self.layout):
            name = f"layer_{j}"
            p = tree_map(lambda a: a[i], params["periods"][name])
            x, caches[name], aux = blocks.block_forward(
                p, x, cfg, kind, use_moe, positions)
            aux_sum = {k: aux_sum[k] + aux[k] if k in aux else aux_sum[k]
                       for k in keys}
        return x, caches, aux_sum

    def _periods_remat(self, params: Tree, x: torch.Tensor,
                       positions: torch.Tensor, keys: Tuple[str, ...],
                       aux_acc: Dict) -> Tuple[torch.Tensor, Dict]:
        """Every period under activation checkpointing: one checkpoint per
        period, and for deep stacks (:meth:`_remat_group` > 1) an outer
        checkpoint per group of periods that keeps only the group's
        input, as the reference's two-level remat does. Recomputation
        runs the same ops on the same inputs (no generator is drawn), so
        it reproduces the forward exactly."""

        def one(i, x, *acc):
            x, _, aux_sum = self._period(params, i, x, positions, keys)
            return (x,) + tuple(a + aux_sum[k] for a, k in zip(acc, keys))

        def run(lo, hi, x, *acc):
            carry = (x,) + acc
            for i in range(lo, hi):
                carry = checkpoint(one, i, *carry, use_reentrant=False,
                                   context_fn=checkpoint_contexts)
            return carry

        group = self._remat_group()
        carry = (x,) + tuple(aux_acc[k] for k in keys)
        for g0 in range(0, self.n_periods, group):
            if group > 1:
                carry = checkpoint(run, g0, g0 + group, *carry,
                                   use_reentrant=False,
                                   context_fn=checkpoint_contexts)
            else:
                carry = run(g0, g0 + 1, *carry)
        return carry[0], dict(zip(keys, carry[1:]))

    def _backbone(self, params: Tree, batch: Dict[str, torch.Tensor], *,
                  want_cache: bool
                  ) -> Tuple[torch.Tensor, Optional[Tree], Dict]:
        """Embed, every layer in depth order (causal, positions 0..S-1),
        final norm. Returns (x, cache, the summed MoE aux). With
        ``want_cache`` the cache is the per-layer K/V ``[n_periods, B, S,
        KV, hd]`` or mamba state (leftover layers unstacked), else
        None. With ``remat`` set (and no cache wanted) the periods run
        under activation checkpointing."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        keys = ("moe_aux_loss", "moe_drop_frac") if cfg.moe else ()
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_acc = {k: zero for k in keys}
        periods = {f"layer_{j}": [] for j in range(len(self.layout))}
        if self.remat and not want_cache and torch.is_grad_enabled():
            x, aux_acc = self._periods_remat(params, x, positions, keys,
                                             aux_acc)
        else:
            for i in range(self.n_periods):
                x, caches, aux_sum = self._period(params, i, x, positions,
                                                  keys)
                aux_acc = {k: aux_acc[k] + aux_sum[k] for k in keys}
                if want_cache:
                    for name, c in caches.items():
                        periods[name].append(c)
        leftover = {}
        for j in range(len(self.leftover)):
            kind, use_moe = self.layout[j]
            name = f"layer_{j}"
            x, c, aux = blocks.block_forward(params["leftover"][name], x,
                                             cfg, kind, use_moe, positions)
            aux_acc = {k: aux_acc[k] + aux[k] if k in aux else aux_acc[k]
                       for k in keys}
            leftover[name] = c
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if not want_cache:
            return x, None, aux_acc
        if self.n_periods:
            stacked = {name: {n: torch.stack([c[n] for c in cs])
                              for n in cs[0]}
                       for name, cs in periods.items()}
        else:
            # no whole period (jamba cut below its 8-layer pattern): the
            # reference's scan still emits every entry, empty
            stacked = self.init_cache(b, s, x.device)["periods"]
        return x, {"periods": stacked, "leftover": leftover}, aux_acc

    # ---------------------------------------------------------------- loss
    def loss_fn(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token NLL (``logits[t]`` predicts ``labels[t]``)
        over the positions ``batch["mask"]`` keeps (all without one).
        Returns (loss, metrics ``{"loss", "tokens"}``); an MoE model adds
        ``moe_aux_loss`` — the summed aux over the stacked MoE layers'
        count, the reference's divisor — at weight 0.01 into the loss,
        and reports it and ``total_loss``."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"]
        ll = label_log_probs(logits, labels)
        mask = batch.get("mask")
        mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
        loss = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        metrics = {"loss": loss, "tokens": torch.sum(mask)}
        if "moe_aux_loss" in aux:
            n_moe = sum(1 for _, m in self.layout if m) * self.n_periods
            aux_loss = aux["moe_aux_loss"] / max(n_moe, 1)
            metrics["moe_aux_loss"] = aux_loss
            loss = loss + 0.01 * aux_loss
            metrics["total_loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------- serving
    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor], *,
                max_len: Optional[int] = None,
                length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
        """Run the prompt ``batch["tokens"]`` [B,S] (the stub frontend's
        ``batch["embeds"]`` [B,S,D]) and build the contiguous cache.
        Returns (last logits [B,V], cache).

        Without ``length`` (the only form for a model with a mamba
        layer: its prefill is recurrent, so prompts run at their exact
        length) the logits are position S-1's and ``len`` is
        the scalar S. With ``length`` ([B], right-padded prompts) they are
        position ``clip(length - 1, 0, S - 1)``'s per row and ``len`` is
        that vector, so decode attends only to real tokens. K/V are
        zero-padded on the time axis to ``max_len`` (default S)."""
        x, cache, _ = self._backbone(params, batch, want_cache=True)
        s = x.shape[1]
        if length is None:
            logits = self._unembed(params, x[:, -1:, :])[:, 0]
            ln = torch.tensor(s, dtype=torch.int32, device=x.device)
        else:
            ln = torch.as_tensor(length, device=x.device).to(torch.int32)
            rows = torch.arange(x.shape[0], device=x.device)
            x_last = x[rows, torch.clamp(ln.long() - 1, 0, s - 1)]
            logits = self._unembed(params, x_last[:, None, :])[:, 0]
        cache = self._pad_cache(cache, s, max_len or s)
        cache["len"] = ln
        return logits, cache

    @staticmethod
    def _pad_cache(cache: Tree, s: int, max_len: int) -> Tree:
        """Zero-pad every k/v leaf's time axis (``ndim - 3``: after the
        stacked-period and batch axes) from ``s`` to ``max_len``; the
        mamba state has no time axis and is left as it is."""
        if max_len < s:
            raise ValueError(f"max_len {max_len} is shorter than the "
                             f"prompt ({s})")

        def pad_entry(entry):
            return {n: pad(a) if n in TIME_LEAVES else a
                    for n, a in entry.items()}

        def pad(a):
            t_axis = a.dim() - 3
            shape = list(a.shape)
            shape[t_axis] = max_len - s
            return torch.cat([a, a.new_zeros(shape)], dim=t_axis)

        return {g: {name: pad_entry(e) for name, e in cache[g].items()}
                for g in ("periods", "leftover")}

    def prefill_chunk(self, params: Tree, cache: Tree, tokens: torch.Tensor,
                      positions: torch.Tensor, write_pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tree]:
        """One chunk of chunked prefill against the cache (paged when it
        carries ``pages``, else contiguous). Returns (logits [B,C,V],
        cache). ``tokens``/``positions``/``write_pos`` are [B,C]; lanes
        whose ``write_pos`` is out of the table or the row (the engine's
        drop sentinel) write nothing. ``len`` does not advance — the
        prefill cursor is engine state. A model with a mamba layer
        raises, as its block does."""
        cfg = self.cfg
        if "mamba" in cfg.layer_pattern:
            raise ValueError(blocks.MAMBA_NOT_CHUNKED)
        with span("model.prefill_chunk"):
            pages = cache.get("pages")
            if pages is not None:
                plan = attn.page_write_plan(pages, write_pos,
                                            *self._arena_shape(cache))
            else:
                plan = attn.row_write_plan(write_pos,
                                           self._arena_shape(cache)[1])
            x = self._embed(params, tokens)
            for p, c, kind, use_moe in self._layers(params, cache):
                x, _ = blocks.block_prefill_chunk(
                    p, x, c, cfg, kind, use_moe, positions, write_pos,
                    pages, write_plan=plan)
            x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
            return self._unembed(params, x), cache

    def decode_step(self, params: Tree, cache: Tree,
                    token_or_embed: torch.Tensor, *,
                    attn_impl: str = "gather") -> Tuple[torch.Tensor, Tree]:
        """One decode step. ``token_or_embed``: token ids [B], or for the
        stub frontend the next embedding [B,D] (never read as ids).
        Returns (logits [B,V], cache with ``len + 1``). A cache with
        ``pages`` takes the paged path, where ``attn_impl`` picks the
        read (``"gather"`` or ``"fused"``);
        otherwise the contiguous one, at a scalar or per-row ``len``. A
        mamba layer steps its slot-dense state; the block table does not
        touch it."""
        with span("model.decode_step"):
            cfg = self.cfg
            cache_len = cache["len"]
            pages = cache.get("pages")
            plan = None           # one write plan serves every layer
            arena = self._arena_shape(cache)
            if arena is not None and pages is not None:
                plan = attn.page_write_plan(pages, cache_len, *arena)
            elif arena is not None and cache_len.dim() == 1:
                plan = attn.row_write_plan(cache_len, arena[1])
            if cfg.frontend is None:
                x = self._embed(params, token_or_embed[:, None])
            else:
                x = token_or_embed.to(cfg.dtype)
                if x.dim() == 2:
                    x = x[:, None, :]
                x = constrain_batch(x)
            for p, c, kind, use_moe in self._layers(params, cache):
                x, _ = blocks.block_decode(
                    p, x, c, cache_len, cfg, kind, use_moe, pages,
                    attn_impl=attn_impl, write_plan=plan)
            x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
            logits = self._unembed(params, x)[:, 0]
            out = dict(cache)
            out["len"] = cache_len + 1
            return logits, out
