"""Paged KV arena: a page-pool allocator + a block-table slot pool
(counterpart of ``repro.serve.kv_pages``; prefix sharing, the
copy-on-write split, the prefix index and ``insert``'s shared-prefix
arguments are not ported yet).

  * one ``[num_pages, page_size, KV, hd]`` arena per layer and k/v,
    shared by all K slots, as torch tensors on the engine's device;
  * a per-slot *block table* — ``[K, max_pages_per_slot]`` int32 rows of
    page ids, sentinel-filled past the slot's allocation — kept in numpy
    on the host (the scheduler edits it every round) and uploaded with
    each dispatch;
  * ``PagePool`` — the FIFO free-list allocator those tables draw from,
    gated by the sync library's Algorithm-3 ticket mutex (one atomic to
    acquire, zero to release, FIFO-fair). Every entry point is batched:
    one critical section per scheduler round covers a whole admission
    batch (``alloc_batch``), growth pass (``PagedSlotPool.grow_batch``)
    or retirement set (``free_batch``), so lock traffic is O(1) per
    round. A batch is a transaction: validation comes first, and every
    mutation pushes a reversing closure onto an undo journal replayed
    newest-first if anything raises inside the section.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.abstraction import PrimitiveKind, WaitStrategy
from repro_torch.core.device import resolve_device
from repro_torch.serve.kv_slots import cache_leaves
from repro_torch.sync import SyncLibrary

Tree = Dict[str, Any]


class PagePoolExhausted(RuntimeError):
    """An all-or-nothing batch asked for more pages than are free."""


class PageLeakError(RuntimeError):
    """A refcount operation that would corrupt the arena's ownership:
    decref of a free or out-of-range page, or more decrefs of a page in
    one batch than it holds references (the next two grants would alias
    one physical page), or an incref of a free page. Refused atomically:
    every id in a batch is validated before any count moves."""


#: wait_mode name -> pinned ticket-lock wait strategy ("auto"/None defer
#: to ``select_impl``; "adaptive" re-selects from measured contention).
_WAIT_MODES = {
    "spin": WaitStrategy.SPIN,
    "spin_backoff": WaitStrategy.SPIN_BACKOFF,
    "sleeping": WaitStrategy.SLEEP,
}


class PagePool:
    """FIFO free list + per-page refcounts under one ticket mutex.

    ``grant_log`` records the tag of every granted request in lock-grant
    order (FIFO in ticket order; a batch appends in batch order). A
    granted page starts at refcount 1, ``incref_batch`` adds a reader,
    and ``free_batch`` decrefs — a page returns to the free list when
    its count hits zero. ``fault_hook(stage)``, when set, is called at
    named points inside the critical section; if it raises, the undo
    journal rolls the batch back and the exception propagates.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 sync: Optional[SyncLibrary] = None,
                 expected_contention: float = 0.25,
                 wait_mode: Optional[str] = None):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        if wait_mode not in (None, "auto", "adaptive", *_WAIT_MODES):
            raise ValueError(
                f"unknown wait_mode {wait_mode!r}; expected auto, adaptive, "
                f"or one of {sorted(_WAIT_MODES)}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.sync = sync if sync is not None else SyncLibrary.host_default()
        self.choice = self.sync.choice(
            PrimitiveKind.MUTEX, expected_contention=expected_contention)
        self.wait_mode = wait_mode or "auto"
        if self.wait_mode == "adaptive":
            self.mutex = self.sync.mutex(
                kind="adaptive", expected_contention=expected_contention)
        else:
            self.mutex = self.sync.mutex(
                kind="ticket", expected_contention=expected_contention,
                strategy=_WAIT_MODES.get(self.wait_mode))
        self._free = collections.deque(range(num_pages))
        self._allocated = np.zeros(num_pages, bool)
        self._refcount = np.zeros(num_pages, np.int32)
        self.allocs = 0          # granted requests (grant_log entries)
        self.frees = 0           # free events (one per returned group)
        self.pages_alloced = 0   # pages moved out of the free list
        self.pages_freed = 0     # pages moved back
        self.increfs = 0
        self.decrefs = 0
        self.peak_in_use = 0
        self.grant_log: List[Any] = []
        self.fault_hook = None
        self.aborted_batches = 0

    # ----------------------------------------------------------------- state
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def wait_strategy(self) -> WaitStrategy:
        """The wait strategy the allocator's mutex runs right now."""
        s = getattr(self.mutex, "strategy", None)      # AdaptiveMutex
        if isinstance(s, WaitStrategy):
            return s
        return getattr(self.mutex, "_strategy",
                       self.sync.strategy or self.choice.strategy)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` flat positions."""
        return -(-max(int(tokens), 0) // self.page_size)

    # ------------------------------------------------------------- hot path
    def alloc_batch(self, counts: Sequence[int],
                    tags: Optional[Sequence] = None, *,
                    partial: bool = False) -> List[Optional[np.ndarray]]:
        """Grant a batch of page requests under ONE critical section.

        ``counts[i]`` pages go to request ``i`` (FIFO page-reuse order,
        requests granted in batch order). With ``partial=False`` the
        batch is all-or-nothing (:class:`PagePoolExhausted`, nothing
        granted); with ``partial=True`` the FIFO *prefix* that fits is
        granted and every request from the first unsatisfiable one on
        gets ``None`` — a later, smaller request never leapfrogs an
        earlier starved one.
        """
        counts = [int(n) for n in counts]
        if any(n < 0 for n in counts):
            raise ValueError("alloc of negative page count")
        if tags is None:
            tags = [None] * len(counts)
        if len(tags) != len(counts):
            raise ValueError("tags and counts length mismatch")
        out: List[Optional[np.ndarray]] = []
        with self.mutex:
            if not partial and sum(counts) > len(self._free):
                raise PagePoolExhausted(
                    f"need {sum(counts)} pages, {len(self._free)} free of "
                    f"{self.num_pages}")
            undo: List[Any] = []
            try:
                self._fire("alloc:validated")
                starved = False
                for n, tag in zip(counts, tags):
                    if starved or n > len(self._free):
                        starved = True          # FIFO prefix only
                        out.append(None)
                        continue
                    ids = np.asarray(
                        [self._free.popleft() for _ in range(n)], np.int32)
                    self._allocated[ids] = True
                    self._refcount[ids] = 1
                    self.allocs += 1
                    self.pages_alloced += n
                    self.grant_log.append(tag)
                    out.append(ids)
                    undo.append(self._undo_grant(ids, n))
                    self._fire("alloc:grant")
            except BaseException:
                self._rollback(undo)
                raise
            self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def _fire(self, stage: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(stage)

    def _undo_grant(self, ids: np.ndarray, n: int):
        def _undo():
            self.grant_log.pop()
            self.allocs -= 1
            self.pages_alloced -= n
            self._refcount[ids] = 0
            self._allocated[ids] = False
            # push back in reverse so the FIFO order is byte-identical
            # to a pool that never saw the aborted batch
            for p in reversed(ids.tolist()):
                self._free.appendleft(int(p))
        return _undo

    def _rollback(self, undo: List[Any]) -> None:
        """(Lock held.) Reverse every journaled mutation, newest first."""
        for fn in reversed(undo):
            fn()
        self.aborted_batches += 1

    def _check_incref(self, g: np.ndarray) -> None:
        for i in g.tolist():
            if not (0 <= i < self.num_pages):
                raise PageLeakError(f"incref of page {i} outside the arena "
                                    f"[0, {self.num_pages})")
            if not self._allocated[i]:
                raise PageLeakError(f"incref of page {i} which is free")

    def _decref_groups(self, groups: List[np.ndarray],
                       undo: List[Any]) -> List[int]:
        """(Lock held.) Validate then apply a batch of decrefs; pages
        whose count hits zero return to the free-list tail in group
        order. A closure reversing the application joins ``undo``."""
        occ: Dict[int, int] = {}
        for g in groups:
            for i in g.tolist():
                if not (0 <= i < self.num_pages):
                    raise PageLeakError(f"freeing page {i} outside the "
                                        f"arena [0, {self.num_pages})")
                if not self._allocated[i]:
                    raise PageLeakError(
                        f"freeing page {i} which is already free — a "
                        f"double free would put it on the free list twice")
                occ[i] = occ.get(i, 0) + 1
                if occ[i] > int(self._refcount[i]):
                    raise PageLeakError(
                        f"page {i} decref'd beyond its "
                        f"{int(self._refcount[i])} reference(s) in one batch")
        freed: List[int] = []
        applied: List[Tuple[int, bool]] = []
        for g in groups:
            for i in g.tolist():
                self._refcount[i] -= 1
                self.decrefs += 1
                went_free = self._refcount[i] == 0
                applied.append((i, went_free))
                if went_free:
                    self._allocated[i] = False
                    self._free.append(i)
                    freed.append(i)
            self.frees += 1
        self.pages_freed += len(freed)
        n_groups, n_freed = len(groups), len(freed)

        def _undo():
            for i, went_free in reversed(applied):
                if went_free:
                    self._free.pop()
                    self._allocated[i] = True
                self._refcount[i] += 1
                self.decrefs -= 1
            self.frees -= n_groups
            self.pages_freed -= n_freed
        undo.append(_undo)
        return freed

    def incref_batch(self, groups: Sequence) -> None:
        """Add one reference to every page of every group, under ONE
        critical section; atomic across the batch."""
        groups = [np.asarray(g, np.int32).reshape(-1) for g in groups]
        with self.mutex:
            for g in groups:
                self._check_incref(g)
            for g in groups:
                self._refcount[g] += 1
                self.increfs += int(g.size)

    def free_batch(self, groups: Sequence) -> List[int]:
        """Drop one reference per listed page under ONE critical section;
        return the ids actually freed (refcount hit zero). Each group is
        one free event."""
        groups = [np.asarray(g, np.int32).reshape(-1) for g in groups]
        with self.mutex:
            undo: List[Any] = []
            try:
                self._fire("free:enter")
                freed = self._decref_groups(groups, undo)
                self._fire("free:decrefs")
            except BaseException:
                self._rollback(undo)
                raise
            return freed

    def refcounts(self, ids) -> np.ndarray:
        """Current reference counts (advisory snapshot, no lock)."""
        return self._refcount[np.asarray(ids, np.int32).reshape(-1)].copy()

    # ----------------------------------------------------- contention signal
    def observed_contention(self) -> float:
        return float(self.mutex.recent_contention())

    def retune(self) -> Optional[WaitStrategy]:
        """Adaptive mode: re-select the wait strategy from the measured
        contention window (between scheduler rounds). No-op otherwise."""
        retune = getattr(self.mutex, "retune", None)
        if retune is None:
            return None
        return retune(self.observed_contention())

    def lock_stats(self) -> dict:
        """Acquire/contended-acquire/held-time counters of the guarding
        mutex, plus the strategy in effect."""
        st = dict(self.mutex.lock_stats())
        st["strategy"] = self.wait_strategy.value
        st["wait_mode"] = self.wait_mode
        return st

    def check(self) -> None:
        """Free list, allocation bitmap and refcounts tell one story."""
        free = list(self._free)
        assert len(set(free)) == len(free), "duplicate page on free list"
        assert not self._allocated[free].any(), "free page marked allocated"
        assert int(self._allocated.sum()) + len(free) == self.num_pages, \
            "pages leaked: allocated + free != arena"
        assert ((self._refcount > 0) == self._allocated).all(), \
            "refcounts disagree with the allocation bitmap"


class PagedSlotPool:
    """Block-table KV pool: K slots over one shared page arena.

    ``max_len`` sizes the arena (default ``ceil(K * max_len /
    page_size)`` pages, the contiguous layout's bytes) while one slot may
    grow to ``max_pages_per_slot * page_size`` tokens (default two rows'
    worth) — the point of paging. The arena lives on ``device``
    (``cuda`` unless the caller asks for ``cpu``).
    """

    def __init__(self, model, capacity: int, max_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 sync: Optional[SyncLibrary] = None,
                 expected_contention: float = 0.25,
                 wait_mode: Optional[str] = None,
                 device=None):
        if capacity < 1:
            raise ValueError("slot pool capacity must be >= 1")
        self.capacity = capacity
        self.max_len = max_len
        self.page_size = page_size
        self.device = resolve_device(device)
        if num_pages is None:
            num_pages = -(-capacity * max_len // page_size)
        self.pages = PagePool(num_pages, page_size, sync=sync,
                              expected_contention=expected_contention,
                              wait_mode=wait_mode)
        if max_pages_per_slot is None:
            max_pages_per_slot = -(-2 * max_len // page_size)
        self.max_pages_per_slot = min(max_pages_per_slot, num_pages)
        # a cache of batch num_pages and length page_size has exactly
        # the arena's shape on every k/v leaf
        arena = model.init_cache(num_pages, page_size, self.device)
        arena.pop("len")
        self.arena: Tree = arena
        self.lens = torch.zeros(capacity, dtype=torch.int32,
                                device=self.device)
        # sentinel = num_pages: reads clip it, writes drop it
        self._tables = np.full((capacity, self.max_pages_per_slot),
                               num_pages, np.int32)
        self._free: List[int] = list(range(capacity))
        self._rid: List[Optional[int]] = [None] * capacity

    # ------------------------------------------------------------- free list
    @property
    def virtual_max_len(self) -> int:
        """Longest context one slot can hold."""
        return self.max_pages_per_slot * self.page_size

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    def acquire(self, rid: int) -> int:
        """Claim the next free slot (FIFO reuse order) for request rid."""
        if not self._free:
            raise RuntimeError("slot pool exhausted — admission must gate "
                               "on the semaphore before acquiring")
        slot = self._free.pop(0)
        self._rid[slot] = rid
        return slot

    def evict(self, slot: int) -> np.ndarray:
        """Retire a slot and reset its table row to sentinel. Returns the
        held page ids: the caller frees a whole round's retirements in
        one ``free_batch``."""
        if self._rid[slot] is None:
            raise RuntimeError(f"evicting free slot {slot}")
        held = self._tables[slot][self._tables[slot] < self.pages.num_pages]
        self._tables[slot] = self.pages.num_pages
        self._rid[slot] = None
        self._free.append(slot)
        return held

    # ------------------------------------------------------------- admission
    def can_reserve(self, tokens: int, pending_pages: int = 0) -> bool:
        """Whether an insert reserving ``tokens`` flat positions can be
        granted now (eager growth's admission gate); ``pending_pages``
        counts grants staged earlier in the same admission batch."""
        n = self.pages.pages_for(tokens)
        return (n <= self.max_pages_per_slot
                and n + max(int(pending_pages), 0) <= self.pages.n_free)

    def can_admit_lazy(self, initial_tokens: int, total_tokens: int,
                       headroom_pages: int = 0,
                       pending_pages: int = 0) -> bool:
        """Lazy-growth admission gate: the initial grant must fit now,
        plus a headroom kept free for in-flight top-ups; the worst case
        only has to respect the per-slot page bound. ``pending_pages``
        counts grants staged earlier in the same admission batch. An
        empty pool waives the headroom (the sole request always fits by
        the per-slot bound, and waiting would deadlock)."""
        if self.pages.pages_for(total_tokens) > self.max_pages_per_slot:
            return False
        need_now = (self.pages.pages_for(initial_tokens)
                    + max(int(pending_pages), 0))
        avail = self.pages.n_free
        if self.n_active == 0 and pending_pages == 0:
            return need_now <= avail
        return need_now + max(int(headroom_pages), 0) <= avail

    def held_pages(self, slot: int) -> int:
        return int((self._tables[slot] < self.pages.num_pages).sum())

    def masked_table(self, slots=()) -> torch.Tensor:
        """The block table on the device, with the given slots' rows
        sentinel — a paused row can then neither write its pages (its
        scatters drop) nor matter to anyone's reads."""
        tbl = self._tables.copy()
        idx = list(slots)
        if idx:
            tbl[idx] = self.pages.num_pages
        return torch.from_numpy(tbl).to(self.device)

    def grow_batch(self, grow_items: Sequence[Tuple[int, int]]
                   ) -> List[bool]:
        """Top up ``[(slot, need_tokens), ...]`` (oldest grant first)
        under ONE allocator critical section; the FIFO prefix that fits
        is granted. Returns one bool per item: True when the slot now
        covers ``need_tokens``. (The reference's ``prepare_batch`` also
        folds copy-on-write splits into this section; sharing is not
        ported yet, so its grow part is this.)"""
        plan = []                     # (idx, slot, held, extra)
        grow_ok = [True] * len(grow_items)
        for idx, (slot, need_tokens) in enumerate(grow_items):
            if self._rid[slot] is None:
                raise RuntimeError(f"growing free slot {slot}")
            need = self.pages.pages_for(need_tokens)
            if need > self.max_pages_per_slot:
                raise ValueError(
                    f"slot {slot} growth to {need_tokens} tokens needs "
                    f"{need} pages > max_pages_per_slot "
                    f"{self.max_pages_per_slot}")
            held = self.held_pages(slot)
            if need > held:
                plan.append((idx, slot, held, need - held))
        if not plan:
            return grow_ok
        grants = self.pages.alloc_batch(
            [extra for (*_, extra) in plan],
            [self._rid[slot] for (_, slot, _, _) in plan], partial=True)
        for (idx, slot, held, _), ids in zip(plan, grants):
            if ids is None:
                grow_ok[idx] = False
                continue
            self._tables[slot, held:held + ids.size] = ids
        return grow_ok

    def reserve_batch(self, items: Sequence[Tuple[int, int]]
                      ) -> List[np.ndarray]:
        """Pre-grant ``[(slot, reserve_tokens), ...]`` in ONE critical
        section, all-or-nothing, one grant-log entry per request."""
        counts = []
        for slot, tokens in items:
            n = self.pages.pages_for(tokens)
            if n > self.max_pages_per_slot:
                raise ValueError(
                    f"reserve {tokens} needs {n} pages > "
                    f"max_pages_per_slot {self.max_pages_per_slot}")
            counts.append(n)
        return self.pages.alloc_batch(
            counts, [self._rid[slot] for slot, _ in items])

    def insert(self, slot: int, req_cache: Tree, length,
               reserve: Optional[int] = None,
               ids: Optional[np.ndarray] = None) -> None:
        """Scatter a prefilled batch-1 request cache (time axis S, the
        prompt's bucket) into ``slot``'s pages and set its length.

        ``reserve`` is the flat positions claimed at insert: the worst
        case under eager growth, the prefill bucket under lazy growth
        (default a full ``max_len`` row). ``ids`` are pages pre-granted
        by :meth:`reserve_batch`; without them the insert allocates its
        own (one critical section). The prefill data fills the first
        ``ceil(S / ps)`` pages (the last one zero-padded); the rest of
        the grant holds stale bytes masked by the length until decode
        writes them."""
        s = cache_leaves(req_cache)[0][3].shape[-3]
        reserve = max(int(reserve) if reserve is not None else self.max_len,
                      s, int(length))
        n_total = self.pages.pages_for(reserve)
        if n_total > self.max_pages_per_slot:
            raise ValueError(
                f"reserve {reserve} needs {n_total} pages > "
                f"max_pages_per_slot {self.max_pages_per_slot}")
        n_data = self.pages.pages_for(s)
        if ids is None:
            ids = self.pages.alloc_batch([max(n_total, n_data)],
                                         [self._rid[slot]])[0]
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size < n_data:
            raise ValueError(f"pre-granted {ids.size} pages cannot hold the "
                             f"{n_data}-page prefill")
        if ids.size > self.max_pages_per_slot:
            raise ValueError(f"{ids.size} pages exceed max_pages_per_slot "
                             f"{self.max_pages_per_slot}")
        self._tables[slot, :ids.size] = ids
        self._tables[slot, ids.size:] = self.pages.num_pages
        ps = self.page_size
        dst = torch.from_numpy(ids[:n_data].astype(np.int64)).to(self.device)
        for (_, _, _, a), (_, _, _, r) in zip(cache_leaves(self.arena),
                                              cache_leaves(req_cache)):
            ax = a.dim() - 4            # the page axis: after the periods
            r = r.select(ax, 0)         # drop batch 1; time now at ax
            pad = list(r.shape)
            pad[ax] = n_data * ps - s
            r = torch.cat([r, r.new_zeros(pad)], dim=ax)
            r = r.reshape(r.shape[:ax] + (n_data, ps) + r.shape[ax + 1:])
            a[(slice(None),) * ax + (dst,)] = r.to(a.dtype)
        self.lens[int(slot)] = int(length)

    def assign(self, slot: int, ids: Optional[np.ndarray] = None,
               length: int = 0) -> None:
        """Place pre-granted pages in ``slot``'s block table without
        writing any K/V (chunked-prefill admission: the coming chunk
        dispatches write the arena at the slot's cursor) and set its
        length."""
        ids = (np.zeros(0, np.int32) if ids is None
               else np.asarray(ids, np.int32).reshape(-1))
        if ids.size > self.max_pages_per_slot:
            raise ValueError(f"{ids.size} pages exceed max_pages_per_slot "
                             f"{self.max_pages_per_slot}")
        self._tables[slot, :ids.size] = ids
        self._tables[slot, ids.size:] = self.pages.num_pages
        self.lens[int(slot)] = int(length)

    def retune(self):
        return self.pages.retune()

    # ----------------------------------------------------------- cache view
    def cache_view(self) -> Tree:
        """Model-cache form: arena leaves + ``len`` + block table."""
        out = dict(self.arena)
        out["len"] = self.lens
        out["pages"] = self.masked_table()
        return out

    def adopt(self, cache: Tree) -> None:
        """Take back the post-dispatch cache. The arenas were updated in
        place and the block table is host-owned, so only ``len`` moves."""
        self.set_lens(cache["len"])

    def set_lens(self, lens) -> None:
        self.lens = torch.as_tensor(lens, dtype=torch.int32).to(self.device)

    def lens_numpy(self) -> np.ndarray:
        return self.lens.cpu().numpy().astype(np.int64)

    def check(self) -> None:
        """Block tables and the page pool tell one story: every
        allocated page is mapped by exactly ``refcount`` slot rows."""
        self.pages.check()
        mult: Dict[int, int] = {}
        for slot in range(self.capacity):
            row = self._tables[slot]
            real = row[row < self.pages.num_pages]
            if self._rid[slot] is None:
                assert real.size == 0, f"free slot {slot} holds pages"
            else:
                assert (row[:real.size] < self.pages.num_pages).all(), \
                    f"slot {slot} table has sentinel holes"
            for p in real.tolist():
                mult[int(p)] = mult.get(int(p), 0) + 1
        assert sorted(mult) == sorted(
            np.flatnonzero(self.pages._allocated).tolist()), \
            "block tables disagree with the allocation bitmap"
        for p, n in mult.items():
            rc = int(self.pages._refcount[p])
            assert rc == n, (f"page {p} mapped by {n} slot(s) but holds "
                             f"{rc} reference(s)")
