"""Decoder-only language model, serving paths (counterpart of
``repro.models.lm.LM``).

Parameters keep the reference's tree: ``embed/tokens``,
``periods/layer_<j>/...`` stacked over the periods on a leading axis,
``leftover/layer_<j>/...`` for remainder layers, ``final_norm``, and
``lm_head`` when embeddings are untied. The reference scans over the
stacked periods; here a Python loop indexes the leading axis. The
paged cache mirrors the reference's cache tree: ``periods/layer_<j>/k``
is a ``[n_periods, num_pages, ps, KV, hd]`` arena, updated in place by
the layers, plus the engine-owned ``len`` [B] vector and ``pages``
[B, P] block table.

Ported: ``init_cache``, ``prefill_chunk`` and ``decode_step``. One-shot
``prefill``, ``forward`` and ``loss_fn`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from . import attention as attn
from . import blocks
from .common import init_params, stack_specs, tree_map
from .layers import (embed, embedding_spec, lm_head_spec, rmsnorm,
                     rmsnorm_spec, unembed)

Tree = Dict[str, Any]


class LM:
    def __init__(self, cfg):
        if cfg.frontend is not None or cfg.is_encdec:
            raise ValueError(f"{cfg.name}: stub-frontend and encoder-decoder "
                             f"models are not ported yet")
        self.cfg = cfg
        self.n_periods, self.pattern, self.leftover = cfg.periods()
        self.layout = blocks.period_layout(cfg)

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
        tree["embed"] = embedding_spec(cfg.vocab_size, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            tree["lm_head"] = lm_head_spec(cfg.d_model, cfg.vocab_size, dtype)
        return tree

    def init(self, generator: torch.Generator, device) -> Tree:
        """Random weights drawn from ``generator`` on ``device``."""
        return init_params(self.spec_tree(), generator, device)

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int, device) -> Tree:
        """Zero cache tree ``periods/layer_<j>/{k,v}`` of shape
        ``[n_periods, batch_size, max_len, KV, hd]`` (leftover layers
        without the leading axis) plus ``len``. With ``batch_size =
        num_pages`` and ``max_len = page_size`` the k/v leaves are
        exactly the paged arenas (serve.kv_pages.PagedSlotPool)."""
        cfg = self.cfg
        shape = (batch_size, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)

        def entry(lead):
            return {n: torch.zeros(lead + shape, dtype=cfg.dtype,
                                   device=device) for n in ("k", "v")}

        return {
            "periods": {f"layer_{j}": entry((self.n_periods,))
                        for j in range(len(self.layout))},
            "leftover": {f"layer_{j}": entry(())
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

    def _arena_shape(self, cache: Tree) -> Tuple[int, int]:
        k = cache["periods"]["layer_0"]["k"] if self.n_periods else \
            cache["leftover"]["layer_0"]["k"]
        return k.shape[-4], k.shape[-3]        # num_pages, page_size

    def _embed(self, params: Tree, tokens: torch.Tensor) -> torch.Tensor:
        x = embed(params["embed"], tokens).to(self.cfg.dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _unembed(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return unembed(params["embed"], None, x, tie=True)
        return unembed(None, params["lm_head"], x, tie=False)

    # ------------------------------------------------------------- serving
    def prefill_chunk(self, params: Tree, cache: Tree, tokens: torch.Tensor,
                      positions: torch.Tensor, write_pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, Tree]:
        """One chunk of chunked prefill against the paged cache. Returns
        (logits [B,C,V], cache). ``tokens``/``positions``/``write_pos``
        are [B,C]; lanes whose ``write_pos`` is out of the table (the
        engine's drop sentinel) write nothing. ``len`` does not advance —
        the prefill cursor is engine state."""
        cfg = self.cfg
        pages = cache["pages"]
        num_pages, ps = self._arena_shape(cache)
        plan = attn.page_write_plan(pages, write_pos, num_pages, ps)
        x = self._embed(params, tokens)
        for p, c, kind, use_moe in self._layers(params, cache):
            x, _ = blocks.block_prefill_chunk(
                p, x, c, cfg, kind, use_moe, positions, write_pos, pages,
                write_plan=plan)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._unembed(params, x), cache

    def decode_step(self, params: Tree, cache: Tree, tokens: torch.Tensor, *,
                    attn_impl: str = "gather") -> Tuple[torch.Tensor, Tree]:
        """One decode step over the paged cache. ``tokens`` [B]. Returns
        (logits [B,V], cache with ``len + 1``). ``attn_impl`` picks the
        paged read path (``"gather"`` or ``"fused"``)."""
        cfg = self.cfg
        cache_len = cache["len"]
        pages = cache.get("pages")
        if pages is None:
            raise ValueError("decode_step needs the paged cache "
                             "(cache['pages']); the contiguous layout is "
                             "not ported yet")
        num_pages, ps = self._arena_shape(cache)
        plan = attn.page_write_plan(pages, cache_len, num_pages, ps)
        x = self._embed(params, tokens[:, None])
        for p, c, kind, use_moe in self._layers(params, cache):
            x, _ = blocks.block_decode(p, x, c, cache_len, cfg, kind,
                                       use_moe, pages, attn_impl=attn_impl,
                                       write_plan=plan)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._unembed(params, x)[:, 0]
        out = dict(cache)
        out["len"] = cache_len + 1
        return logits, out
