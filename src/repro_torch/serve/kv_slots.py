"""Preallocated contiguous KV slot arena for continuous-batching serving
(counterpart of ``repro.serve.kv_slots``).

One replica owns a fixed ``[K, max_len, ...]`` decode-cache arena — K is
the concurrency budget, the same K that parameterizes the Algorithm-5
admission semaphore. A request occupies exactly one slot (one batch row
of every cache leaf) from admission to retirement; eviction is O(1)
free-list bookkeeping, and the arena is never reallocated, so the
engine's batched ``decode_step`` always runs at one shape.

The arena is ``model.init_cache(K, max_len)`` on the engine's device.
The reference finds each leaf's batch axis by diffing the shapes of a
batch-1 and a batch-2 cache; the port knows its own cache layout and
states it (:func:`batch_axes`): period-stacked leaves carry the batch
on axis 1, leftover-layer leaves on axis 0 — an attention layer's k/v
and a mamba layer's ``conv``/``h`` state alike — and an
encoder-decoder's cross and self K/V on axis 1. ``insert`` writes a
prefilled batch-1 request cache into a slot's row, in place: the whole
state row of a mamba leaf (it has no time axis), the ``max_len`` time
row of a k/v leaf.

``len`` is a per-slot ``[K]`` int32 vector — the model's decode path
takes vector lengths, so each row attends at its own depth. A retired
row keeps advancing with the batch until its slot is reused; its writes
drop once it passes ``max_len`` (``models.attention.scatter_rows``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Tree = Dict[str, Any]


def cache_leaves(cache: Tree) -> List[tuple]:
    """``(group, layer, name, leaf)`` of every state leaf of a cache tree
    (``len`` and ``pages`` stripped), in the reference's flattening
    order: dict keys sorted at every level. An encoder-decoder cache's
    groups (``cross``, ``self``) hold their leaves directly: ``layer``
    is None there."""
    out = []
    for group in sorted(k for k in cache if k not in ("len", "pages")):
        for key in sorted(cache[group]):
            entry = cache[group][key]
            if isinstance(entry, dict):
                out.extend((group, key, name, entry[name])
                           for name in sorted(entry))
            else:
                out.append((group, None, key, entry))
    return out


def batch_axes(model) -> List[int]:
    """Batch axis of every cache leaf, in :func:`cache_leaves` order: 1
    for the period-stacked leaves (``[n_periods, B, T, KV, hd]`` k/v,
    ``[n_periods, B, cw-1, DI]`` conv, ``[n_periods, B, DI, N]`` h), 0
    for the leftover layers'. Every layer holds two leaves. An
    encoder-decoder's four leaves (cross and self K/V, ``[num_layers,
    B, T, KV, hd]``) all carry it on axis 1."""
    if model.cfg.is_encdec:
        return [1] * 4
    return ([0] * 2 * len(model.leftover)      # "leftover" sorts first
            + [1] * 2 * len(model.layout))


class SlotPool:
    """Fixed-capacity KV arena + free list (insert / evict / per-slot len).

    The free list is FIFO (slot reuse order is deterministic), matching
    the FIFO hand-off of the sleeping semaphore that gates admission.
    The arena lives on ``device`` (``cuda`` unless the caller asks for
    ``cpu``) and is updated in place.
    """

    def __init__(self, model, capacity: int, max_len: int, device=None):
        if capacity < 1:
            raise ValueError("slot pool capacity must be >= 1")
        self.capacity = capacity
        self.max_len = max_len
        self.device = resolve_device(device)
        arena = model.init_cache(capacity, max_len, self.device)
        arena.pop("len")
        self.arena: Tree = arena
        self._axes = batch_axes(model)
        self.lens = torch.zeros(capacity, dtype=torch.int32,
                                device=self.device)
        self._free: List[int] = list(range(capacity))
        self._rid: List[Optional[int]] = [None] * capacity

    # ------------------------------------------------------------- free list
    @property
    def virtual_max_len(self) -> int:
        """Longest context one slot can hold (the physical row here; the
        paged layout decouples the two)."""
        return self.max_len

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self, rid: int) -> int:
        """Claim the next free slot (FIFO reuse order) for request rid."""
        if not self._free:
            raise RuntimeError("slot pool exhausted — admission must gate "
                               "on the semaphore before acquiring")
        slot = self._free.pop(0)
        self._rid[slot] = rid
        return slot

    def evict(self, slot: int) -> None:
        """Retire a slot; the stale cache row is overwritten on reuse."""
        if self._rid[slot] is None:
            raise RuntimeError(f"evicting free slot {slot}")
        self._rid[slot] = None
        self._free.append(slot)

    # --------------------------------------------------------------- device
    def insert(self, slot: int, req_cache: Tree, length,
               reserve: Optional[int] = None) -> None:
        """Write a prefilled batch-1 request cache (time axis ``max_len``)
        into ``slot``'s row and set its length. ``reserve`` is a paged
        concern; the contiguous row always holds ``max_len``."""
        del reserve
        for (_, _, _, a), (_, _, _, r), ax in zip(
                cache_leaves(self.arena), cache_leaves(req_cache),
                self._axes):
            idx = (slice(None),) * ax + (slot,)
            a[idx] = r.select(ax, 0).to(a.dtype)
        self.lens[int(slot)] = int(length)

    def assign(self, slot: int, length: int = 0) -> None:
        """Set ``slot``'s length without writing the arena (chunked-prefill
        admission: the chunk dispatches write K/V into the row at the
        engine's cursor, before anything reads them)."""
        self.lens[int(slot)] = int(length)

    def cache_view(self) -> Tree:
        """The arena in model-cache form (arena leaves + ``len``)."""
        out = dict(self.arena)
        out["len"] = self.lens
        return out

    def adopt(self, cache: Tree) -> None:
        """Take back the post-dispatch cache. The arena was updated in
        place, so only ``len`` moves."""
        self.set_lens(cache["len"])

    def set_lens(self, lens) -> None:
        self.lens = torch.as_tensor(lens, dtype=torch.int32).to(self.device)

    def lens_numpy(self) -> np.ndarray:
        return self.lens.cpu().numpy().astype(np.int64)
