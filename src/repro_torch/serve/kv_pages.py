"""Paged KV arena: a page-pool allocator, a prefix index and a
block-table slot pool (counterpart of ``repro.serve.kv_pages``).

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
    batch (``alloc_batch``), page-prep pass (``PagedSlotPool.
    prepare_batch``) or retirement set (``free_batch``), so lock traffic
    is O(1) per round. A batch is a transaction: validation comes first,
    and every mutation pushes a reversing closure onto an undo journal
    replayed newest-first if anything raises inside the section.

Copy-on-write prefix sharing rides on the same sections:

  * **refcounts and epochs** — a grant starts a page at refcount 1 and
    bumps its epoch; adoption is an incref (the ``incref_groups`` rider
    of the admission grant), a free is a decref, and a page returns to
    the free list only when its count hits zero. ``entry_valid`` checks
    a remembered (id, epoch) pair without the lock;
  * ``PrefixIndex`` — chained digests of a prompt's prefix at every full
    page plus its partial tail, pointing at the pages holding that K/V;
  * **the split** — ``prepare_batch`` grants a private page for every
    shared page a slot is about to write, decrefs the source in the same
    section (``paired_decrefs``), copies the page in the arena
    (``models.attention.copy_pages``) and repoints the slot's table. A
    shared page is never written; a written page has refcount 1.

The block tables, refcounts and split plan live on the host: nothing of
the split reads the device back, and the arena copy is one gather and
one scatter per leaf on the engine's stream, ahead of the dispatch.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.abstraction import PrimitiveKind, WaitStrategy
from repro_torch.core.device import resolve_device
from repro_torch.models.attention import copy_planned, page_copy_ids
from repro_torch.models.lm import TIME_LEAVES
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
    """FIFO free list + per-page refcounts and grant epochs under one
    ticket mutex.

    ``grant_log`` records the tag of every granted request in lock-grant
    order (FIFO in ticket order; a batch appends in batch order). A
    granted page starts at refcount 1, an incref adds a reader, and a
    free decrefs — a page returns to the free list when its count hits
    zero. ``fault_hook(stage)``, when set, is called at named points
    inside the critical section; if it raises, the undo journal rolls
    the batch back and the exception propagates. ``watchdog_s`` arms the
    mutex's holder watchdog: a critical section held longer counts one
    ``watchdog_trips`` in :meth:`lock_stats`.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 sync: Optional[SyncLibrary] = None,
                 expected_contention: float = 0.25,
                 wait_mode: Optional[str] = None,
                 watchdog_s: Optional[float] = None):
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
        self._epoch = np.zeros(num_pages, np.int64)   # bumped per grant
        self.allocs = 0          # granted requests (grant_log entries)
        self.frees = 0           # free events (one per returned group)
        self.pages_alloced = 0   # pages moved out of the free list
        self.pages_freed = 0     # pages moved back
        self.increfs = 0         # shared-adoption references added
        self.decrefs = 0         # references dropped (>= pages_freed)
        self.peak_in_use = 0
        self.grant_log: List[Any] = []
        self.fault_hook = None
        self.aborted_batches = 0
        if watchdog_s is not None:
            wd = getattr(self.mutex, "set_watchdog", None)
            if wd is not None:
                wd(watchdog_s)

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
                    partial: bool = False,
                    incref_groups: Optional[Sequence] = None,
                    paired_decrefs: Optional[Sequence] = None,
                    decref_groups: Optional[Sequence] = None
                    ) -> List[Optional[np.ndarray]]:
        """Grant a batch of page requests under ONE critical section.

        ``counts[i]`` pages go to request ``i`` (FIFO page-reuse order,
        requests granted in batch order). With ``partial=False`` the
        batch is all-or-nothing (:class:`PagePoolExhausted`, nothing
        granted); with ``partial=True`` the FIFO *prefix* that fits is
        granted and every request from the first unsatisfiable one on
        gets ``None`` — a later, smaller request never leapfrogs an
        earlier starved one.

        Three refcount riders share the section, so sharing never costs
        an extra acquire:

          * ``incref_groups`` — prefix adoptions, applied first;
          * ``decref_groups`` — unconditional decrefs (the prefix cache's
            eviction), applied after the increfs and before the grants,
            so the pages they free fund this very batch;
          * ``paired_decrefs`` — aligned with ``counts``: group ``i`` is
            decref'd iff request ``i`` was granted (a CoW split drops its
            shared source only when its private copy exists).

        Failure is atomic for the whole call: increfs, decrefs (the
        paired ones validated as if every request were granted) and
        exhaustion are checked before any count moves.
        """
        counts = [int(n) for n in counts]
        if any(n < 0 for n in counts):
            raise ValueError("alloc of negative page count")
        if tags is None:
            tags = [None] * len(counts)
        if len(tags) != len(counts):
            raise ValueError("tags and counts length mismatch")
        if paired_decrefs is not None and len(paired_decrefs) != len(counts):
            raise ValueError("paired_decrefs and counts length mismatch")
        inc = [np.asarray(g, np.int32).reshape(-1)
               for g in (incref_groups or [])]
        paired = ([None if g is None
                   else np.asarray(g, np.int32).reshape(-1)
                   for g in paired_decrefs]
                  if paired_decrefs is not None else None)
        dec = [np.asarray(g, np.int32).reshape(-1)
               for g in (decref_groups or [])]
        out: List[Optional[np.ndarray]] = []
        with self.mutex:
            for g in inc:
                self._check_incref(g)
            if paired is not None or dec:
                self._check_rider_decrefs(inc, dec, paired)
            # the eviction rider's credit: only decrefs that free a page
            # count — refcount 1 and not re-adopted by this call
            inc_pages = {i for g in inc for i in g.tolist()}
            if not partial and sum(counts) > len(self._free) + sum(
                    1 for g in dec for i in g.tolist()
                    if int(self._refcount[i]) == 1 and i not in inc_pages):
                raise PagePoolExhausted(
                    f"need {sum(counts)} pages, {len(self._free)} free of "
                    f"{self.num_pages}")
            undo: List[Any] = []
            try:
                self._fire("alloc:validated")
                # increfs land first: a rider that increfs and decrefs
                # one page nets out instead of freeing it under its reader
                for g in inc:
                    self._refcount[g] += 1
                    self.increfs += int(g.size)
                    undo.append(self._undo_incref(g))
                self._fire("alloc:increfs")
                if dec:
                    self._decref_groups(dec, True, undo)
                self._fire("alloc:evict_decrefs")
                starved = False
                granted_decrefs = []
                for i, (n, tag) in enumerate(zip(counts, tags)):
                    if starved or n > len(self._free):
                        starved = True          # FIFO prefix only
                        out.append(None)
                        continue
                    ids = np.asarray(
                        [self._free.popleft() for _ in range(n)], np.int32)
                    self._allocated[ids] = True
                    self._refcount[ids] = 1
                    self._epoch[ids] += 1
                    self.allocs += 1
                    self.pages_alloced += n
                    self.grant_log.append(tag)
                    out.append(ids)
                    undo.append(self._undo_grant(ids, n))
                    if paired is not None and paired[i] is not None:
                        granted_decrefs.append(paired[i])
                    self._fire("alloc:grant")
                if granted_decrefs:
                    self._decref_groups(granted_decrefs, False, undo)
                self._fire("alloc:paired_decrefs")
            except BaseException:
                self._rollback(undo)
                raise
            self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def _check_rider_decrefs(self, inc, dec, paired) -> None:
        """(Lock held.) The eviction and paired decrefs of one call,
        against one occurrence map: no page may lose more references
        than it holds after this call's increfs."""
        inc_count: Dict[int, int] = {}
        for g in inc:
            for i in g.tolist():
                inc_count[i] = inc_count.get(i, 0) + 1
        occ: Dict[int, int] = {}
        for what, groups in (("eviction", dec), ("paired", paired or [])):
            for g in groups:
                for i in ([] if g is None else g.tolist()):
                    if not (0 <= i < self.num_pages):
                        raise PageLeakError(
                            f"{what} decref of page {i} outside the arena "
                            f"[0, {self.num_pages})")
                    if not self._allocated[i]:
                        raise PageLeakError(
                            f"{what} decref of page {i} which is already "
                            f"free")
                    occ[i] = occ.get(i, 0) + 1
                    if occ[i] > int(self._refcount[i]) + inc_count.get(i, 0):
                        raise PageLeakError(
                            f"page {i} {what}-decref'd beyond its held "
                            f"reference(s) — the extra decref would free a "
                            f"page someone still reads")

    def alloc(self, n: int, tag: Any = None) -> np.ndarray:
        """Claim ``n`` pages (FIFO reuse order) — a batch of one."""
        return self.alloc_batch([n], [tag])[0]

    def _fire(self, stage: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(stage)

    def _undo_incref(self, g: np.ndarray):
        def _undo():
            self._refcount[g] -= 1
            self.increfs -= int(g.size)
        return _undo

    def _undo_grant(self, ids: np.ndarray, n: int):
        def _undo():
            self.grant_log.pop()
            self.allocs -= 1
            self.pages_alloced -= n
            self._refcount[ids] = 0
            self._allocated[ids] = False
            self._epoch[ids] -= 1
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

    def _decref_groups(self, groups: List[np.ndarray], count_frees: bool,
                       undo: List[Any]) -> List[int]:
        """(Lock held.) Validate then apply a batch of decrefs; pages
        whose count hits zero return to the free-list tail in group
        order. ``count_frees``: each group is one free event. A closure
        reversing the application joins ``undo``."""
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
                        f"page {i} appears twice in one free batch beyond "
                        f"its {int(self._refcount[i])} held reference(s)")
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
            if count_frees:
                self.frees += 1
        self.pages_freed += len(freed)
        n_events, n_freed = (len(groups) if count_frees else 0), len(freed)

        def _undo():
            for i, went_free in reversed(applied):
                if went_free:
                    self._free.pop()
                    self._allocated[i] = True
                self._refcount[i] += 1
                self.decrefs -= 1
            self.frees -= n_events
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
            undo: List[Any] = []
            try:
                for g in groups:
                    self._refcount[g] += 1
                    self.increfs += int(g.size)
                    undo.append(self._undo_incref(g))
                self._fire("incref:applied")
            except BaseException:
                self._rollback(undo)
                raise

    def free_batch(self, groups: Sequence) -> List[int]:
        """Drop one reference per listed page under ONE critical section;
        return the ids actually freed (refcount hit zero). Each group is
        one free event; a page may sit in several groups (two holders
        retiring in one round) up to its reference count."""
        groups = [np.asarray(g, np.int32).reshape(-1) for g in groups]
        with self.mutex:
            undo: List[Any] = []
            try:
                self._fire("free:enter")
                freed = self._decref_groups(groups, True, undo)
                self._fire("free:decrefs")
            except BaseException:
                self._rollback(undo)
                raise
            return freed

    def free(self, ids) -> List[int]:
        """Drop one reference per page — a batch of one."""
        return self.free_batch([ids])

    # ------------------------------------------------------------ refcounts
    def refcounts(self, ids) -> np.ndarray:
        """Current reference counts (advisory snapshot, no lock)."""
        return self._refcount[np.asarray(ids, np.int32).reshape(-1)].copy()

    def epochs(self, ids) -> np.ndarray:
        """Per-page grant epochs: a remembered (id, epoch) pair names one
        allocation's lifetime."""
        return self._epoch[np.asarray(ids, np.int32).reshape(-1)].copy()

    def entry_valid(self, ids, epochs) -> bool:
        """Whether every (id, epoch) pair still names a live allocation
        (the prefix index's staleness probe; advisory, no lock)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        epochs = np.asarray(epochs, np.int64).reshape(-1)
        if ids.size == 0:
            return True
        if ids.min() < 0 or ids.max() >= self.num_pages:
            return False
        return (bool(self._allocated[ids].all())
                and bool((self._epoch[ids] == epochs).all()))

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

    def reset_stats(self) -> None:
        """Zero the allocation and lock counters (the free list stays)."""
        self.allocs = self.frees = 0
        self.pages_alloced = self.pages_freed = 0
        self.increfs = self.decrefs = 0
        self.aborted_batches = 0
        self.peak_in_use = self.in_use
        self.grant_log.clear()
        self.mutex.reset_stats()

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


class PrefixIndex:
    """Longest-prefix-match index from prompt tokens to live KV pages.

    One entry per full-page boundary of a registered prompt plus one for
    its partial tail. The key is a chained 16-byte ``blake2b`` of the
    token prefix (each full page's int32 bytes; the tail after a
    ``b"\\x00partial"`` marker, so a tail entry matches only a prompt of
    exactly that length — a longer one would have to write the shared
    page), then the prefill bucket and schedule as 4 little-endian bytes
    each — the keys are byte-identical to the reference's. Values are
    ``(page_ids, epochs)``; an entry whose pages were recycled is stale
    and pruned at lookup. The index holds no reference: adoption increfs
    under the admission section.

    ``bucket`` and ``schedule`` keep donor and adopter shape-identical:
    one-shot prefill keys ``(bucket, 0)``, chunked prefill ``(0, C)``, so
    the two never cross-adopt.
    """

    def __init__(self, page_size: int, pool: PagePool):
        self.page_size = int(page_size)
        self.pool = pool
        self._entries: Dict[bytes, Tuple[np.ndarray, np.ndarray]] = {}
        self.hits = 0            # lookups that adopted at least one page
        self.misses = 0
        self.pruned = 0          # stale entries dropped at lookup

    def __len__(self) -> int:
        return len(self._entries)

    def _digests(self, tokens) -> List[Tuple[int, bytes]]:
        """(prefix_len, digest) per full-page boundary, ascending, plus
        the marker-chained partial tail when the length is unaligned."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        h = hashlib.blake2b(digest_size=16)
        out: List[Tuple[int, bytes]] = []
        n_full = tokens.size // ps
        for j in range(n_full):
            h.update(tokens[j * ps:(j + 1) * ps].tobytes())
            out.append(((j + 1) * ps, h.copy().digest()))
        if tokens.size > n_full * ps:
            h.update(b"\x00partial")
            h.update(tokens[n_full * ps:].tobytes())
            out.append((tokens.size, h.digest()))
        return out

    @staticmethod
    def _key(digest: bytes, bucket: int, schedule: int = 0) -> bytes:
        return (digest + int(bucket).to_bytes(4, "little")
                + int(schedule).to_bytes(4, "little"))

    def register(self, tokens, bucket: int, page_ids,
                 schedule: int = 0) -> int:
        """Publish a prompt's prefixes held in ``page_ids`` (the slot's
        table entries covering it, adopted ones included — sharing is
        transitive). A key whose entry is still live keeps its earliest
        donor; dead entries are overwritten. Returns entries written."""
        page_ids = np.asarray(page_ids, np.int32).reshape(-1)
        written = 0
        for length, digest in self._digests(tokens):
            n = -(-length // self.page_size)
            if n > page_ids.size:
                break
            key = self._key(digest, bucket, schedule)
            cur = self._entries.get(key)
            if cur is not None and self.pool.entry_valid(cur[0], cur[1]):
                continue
            ids = page_ids[:n].copy()
            self._entries[key] = (ids, self.pool.epochs(ids))
            written += 1
        return written

    def lookup(self, tokens, bucket: int, schedule: int = 0
               ) -> Tuple[int, Optional[np.ndarray]]:
        """Longest live match ``(shared_len, page_ids)``, or ``(0,
        None)``. The caller increfs the pages under its admission
        section before anything can retire the donor."""
        for length, digest in reversed(self._digests(tokens)):
            key = self._key(digest, bucket, schedule)
            ent = self._entries.get(key)
            if ent is None:
                continue
            ids, epochs = ent
            if not self.pool.entry_valid(ids, epochs):
                del self._entries[key]
                self.pruned += 1
                continue
            self.hits += 1
            return length, ids.copy()
        self.misses += 1
        return 0, None


class PagedSlotPool:
    """Block-table KV pool: K slots over one shared page arena.

    ``max_len`` sizes the arena (default ``ceil(K * max_len /
    page_size)`` pages, the contiguous layout's bytes) while one slot may
    grow to ``max_pages_per_slot * page_size`` tokens (default two rows'
    worth) — the point of paging. The arena lives on ``device``
    (``cuda`` unless the caller asks for ``cpu``).

    Only the ``k``/``v`` leaves are paged. Every other leaf (a mamba
    layer's ``conv``/``h`` state, which has no time axis) stays
    slot-dense, one row per slot, exactly as in ``SlotPool`` — so a
    model with no attention layer (falcon-mamba) keeps an allocator
    whose pages no layer reads, as the reference's does.

    Under prefix sharing one page may sit in several rows at once, and
    :meth:`check` holds "every allocated page is mapped by exactly
    ``refcount`` rows plus its external holders" (the prefix cache).
    """

    def __init__(self, model, capacity: int, max_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 sync: Optional[SyncLibrary] = None,
                 expected_contention: float = 0.25,
                 wait_mode: Optional[str] = None,
                 watchdog_s: Optional[float] = None,
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
                              wait_mode=wait_mode, watchdog_s=watchdog_s)
        if max_pages_per_slot is None:
            max_pages_per_slot = -(-2 * max_len // page_size)
        self.max_pages_per_slot = min(max_pages_per_slot, num_pages)
        # a cache of batch num_pages and length page_size has exactly
        # the arena's shape on every k/v leaf; the state leaves keep one
        # row per slot
        arena = model.init_cache(num_pages, page_size, self.device,
                                 state_batch=capacity)
        arena.pop("len")
        self.arena: Tree = arena
        self.lens = torch.zeros(capacity, dtype=torch.int32,
                                device=self.device)
        # sentinel = num_pages: reads clip it, writes drop it
        self._tables = np.full((capacity, self.max_pages_per_slot),
                               num_pages, np.int32)
        self._free: List[int] = list(range(capacity))
        self._rid: List[Optional[int]] = [None] * capacity
        self._external_holders: List[Any] = []

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

    def evict(self, slot: int, *, free_pages: bool = True
              ) -> Optional[np.ndarray]:
        """Retire a slot and reset its table row to sentinel.
        ``free_pages=True`` decrefs its pages now (one critical section);
        ``free_pages=False`` returns the held ids instead, for the caller
        to free a whole round's retirements in one ``free_batch``."""
        if self._rid[slot] is None:
            raise RuntimeError(f"evicting free slot {slot}")
        held = self._tables[slot][self._tables[slot] < self.pages.num_pages]
        self._tables[slot] = self.pages.num_pages
        self._rid[slot] = None
        self._free.append(slot)
        if free_pages:
            if held.size:
                self.pages.free(held)
            return None
        return held

    # ------------------------------------------------------------- admission
    def can_reserve(self, tokens: int, pending_pages: int = 0,
                    shared_pages: int = 0, extra_free: int = 0) -> bool:
        """Whether an insert reserving ``tokens`` flat positions can be
        granted now (eager growth's admission gate). ``pending_pages``
        counts grants staged earlier in the same batch; ``shared_pages``
        are adopted (incref'd, not granted); ``extra_free`` credits pages
        a planned cache eviction returns in the same section."""
        n = self.pages.pages_for(tokens)
        need_now = max(n - max(int(shared_pages), 0), 0)
        return (n <= self.max_pages_per_slot
                and need_now + max(int(pending_pages), 0)
                <= self.pages.n_free + max(int(extra_free), 0))

    def can_admit_lazy(self, initial_tokens: int, total_tokens: int,
                       headroom_pages: int = 0,
                       pending_pages: int = 0,
                       shared_pages: int = 0,
                       extra_free: int = 0) -> bool:
        """Lazy-growth admission gate: the initial grant (less adopted
        pages) must fit now, plus a headroom kept free for in-flight
        top-ups; the worst case only has to respect the per-slot page
        bound. An empty pool waives the headroom (the sole request
        always fits by the per-slot bound, and waiting would
        deadlock)."""
        if self.pages.pages_for(total_tokens) > self.max_pages_per_slot:
            return False
        need_now = (max(self.pages.pages_for(initial_tokens)
                        - max(int(shared_pages), 0), 0)
                    + max(int(pending_pages), 0))
        avail = self.pages.n_free + max(int(extra_free), 0)
        if self.n_active == 0 and pending_pages == 0:
            return need_now <= avail
        return need_now + max(int(headroom_pages), 0) <= avail

    def held_pages(self, slot: int) -> int:
        return int((self._tables[slot] < self.pages.num_pages).sum())

    def page_ids(self, slot: int, n: Optional[int] = None) -> np.ndarray:
        """The first ``n`` (default all) real page ids of ``slot``'s
        table, in position order — what the prefix index registers."""
        row = self._tables[slot]
        real = row[row < self.pages.num_pages]
        return (real if n is None else real[:n]).copy()

    def masked_table(self, slots=()) -> torch.Tensor:
        """The block table on the device, with the given slots' rows
        sentinel — a paused row can then neither write its pages (in
        particular a shared page whose split starved) nor matter to
        anyone's reads."""
        tbl = self._tables.copy()
        idx = list(slots)
        if idx:
            tbl[idx] = self.pages.num_pages
        return torch.from_numpy(tbl).to(self.device)

    def shared_write_targets(self, slot: int, start_pos: int,
                             end_pos: int) -> List[Tuple[int, int]]:
        """``(table_idx, page_id)`` of the held pages ``slot`` would write
        in flat positions ``[start_pos, end_pos)`` that are shared
        (refcount > 1) — what must be split, or the write withheld."""
        if end_pos <= start_pos:
            return []
        ps = self.page_size
        lo = max(start_pos // ps, 0)
        hi = min((end_pos - 1) // ps, self.held_pages(slot) - 1)
        if hi < lo:
            return []
        idxs = list(range(lo, hi + 1))
        pages = self._tables[slot, idxs]
        rc = self.pages.refcounts(pages)
        return [(j, int(p)) for j, p, r in zip(idxs, pages, rc)
                if int(r) > 1]

    def prepare_batch(self, grow_items: Sequence[Tuple[int, int]],
                      split_items: Sequence[Tuple[int, int]],
                      evict_groups: Sequence = ()
                      ) -> Tuple[List[bool], List[bool]]:
        """A round's page prep in ONE critical section: lazy top-ups
        ``[(slot, need_tokens), ...]`` (FIFO-prefix partial, oldest
        first), then CoW splits ``[(slot, table_idx), ...]`` — one
        private page each, its shared source decref'd in the same section
        only if granted — with the prefix cache's ``evict_groups``
        decref'd before the grants. Then the split pages are copied in
        the arena and the tables repointed. A starved split leaves the
        slot on the shared page: it must pause. Returns ``(grow_ok,
        split_ok)`` aligned with the inputs."""
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
        split_old = [int(self._tables[slot, j]) for slot, j in split_items]
        if not plan and not split_items:
            if evict_groups:
                # nothing to grant, but the planned evictions must land
                # (the cache already forgot them): still one acquire
                self.pages.free_batch(evict_groups)
            return grow_ok, []
        grants = self.pages.alloc_batch(
            [extra for (*_, extra) in plan] + [1] * len(split_items),
            [self._rid[slot] for (_, slot, _, _) in plan]
            + [("cow", self._rid[slot]) for slot, _ in split_items],
            partial=True,
            paired_decrefs=[None] * len(plan) + [[old] for old in split_old],
            decref_groups=list(evict_groups) or None)
        for (idx, slot, held, _), ids in zip(plan, grants):
            if ids is None:
                grow_ok[idx] = False
                continue
            self._tables[slot, held:held + ids.size] = ids
        split_grants = grants[len(plan):]
        src = [old for old, ids in zip(split_old, split_grants)
               if ids is not None]
        dst = [int(ids[0]) for ids in split_grants if ids is not None]
        if src:
            self._copy_arena_pages(np.asarray(src, np.int32),
                                   np.asarray(dst, np.int32))
        split_ok = []
        for (slot, j), ids in zip(split_items, split_grants):
            split_ok.append(ids is not None)
            if ids is not None:
                self._tables[slot, j] = int(ids[0])
        return grow_ok, split_ok

    def _copy_arena_pages(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Device half of the CoW split: pages ``src[i] -> dst[i]`` on
        every k/v leaf along its page axis (after the period axis of a
        stacked leaf), one index upload for all of them."""
        ids = page_copy_ids(src, dst, self.pages.num_pages, self.device)
        for _, _, name, a in cache_leaves(self.arena):
            if name in TIME_LEAVES:
                copy_planned(a, ids, axis=a.dim() - 4)

    def reserve_batch(self, items: Sequence[Tuple[int, int]],
                      shared: Optional[Sequence] = None,
                      evict: Optional[Sequence] = None
                      ) -> List[np.ndarray]:
        """Pre-grant ``[(slot, reserve_tokens), ...]`` in ONE critical
        section, all-or-nothing, one grant-log entry per request.
        ``shared`` (aligned with ``items``: None or a page-id array) are
        prefix adoptions — their count is deducted from the grant and
        they are incref'd in the same section; ``evict`` (page-id
        groups) are cache evictions decref'd before the grants."""
        counts, incref_groups = [], []
        for i, (slot, tokens) in enumerate(items):
            n = self.pages.pages_for(tokens)
            if n > self.max_pages_per_slot:
                raise ValueError(
                    f"reserve {tokens} needs {n} pages > "
                    f"max_pages_per_slot {self.max_pages_per_slot}")
            sh = shared[i] if shared is not None else None
            n_sh = 0 if sh is None else int(np.asarray(sh).size)
            if n_sh:
                incref_groups.append(np.asarray(sh, np.int32).reshape(-1))
            counts.append(max(n - n_sh, 0))
        return self.pages.alloc_batch(
            counts, [self._rid[slot] for slot, _ in items],
            incref_groups=incref_groups or None,
            decref_groups=evict or None)

    def _place(self, slot: int, ids: np.ndarray,
               shared_ids: np.ndarray) -> None:
        n_sh, n_priv = int(shared_ids.size), int(ids.size)
        if n_sh + n_priv > self.max_pages_per_slot:
            raise ValueError(
                f"{n_sh} shared + {n_priv} private pages exceed "
                f"max_pages_per_slot {self.max_pages_per_slot}")
        self._tables[slot, :n_sh] = shared_ids
        self._tables[slot, n_sh:n_sh + n_priv] = ids
        self._tables[slot, n_sh + n_priv:] = self.pages.num_pages

    def insert(self, slot: int, req_cache: Tree, length,
               reserve: Optional[int] = None,
               ids: Optional[np.ndarray] = None,
               shared_ids: Optional[np.ndarray] = None,
               shared_len: int = 0) -> None:
        """Scatter a prefilled batch-1 request cache (time axis S, the
        prompt's bucket) into ``slot``'s pages and set its length.

        ``reserve`` is the flat positions claimed at insert: the worst
        case under eager growth, the prefill bucket under lazy growth
        (default a full ``max_len`` row). ``ids`` are pages pre-granted
        by :meth:`reserve_batch`; without them the insert allocates its
        own (one critical section). ``shared_ids`` / ``shared_len`` are a
        prefix adoption (already incref'd): placed at the head of the
        table and left out of the scatter — a shared page is never
        written; the prefill data for its positions is what the donor
        wrote. The private data fills pages ``n_shared .. ceil(S/ps)-1``
        (the last zero-padded); the rest of the grant holds stale bytes
        masked by the length until decode writes them. Every other leaf
        (the mamba state) is written whole into ``slot``'s row."""
        s = next((r.shape[-3] for _, _, name, r in cache_leaves(req_cache)
                  if name in TIME_LEAVES), 0)
        shared_ids = (np.zeros(0, np.int32) if shared_ids is None
                      else np.asarray(shared_ids, np.int32).reshape(-1))
        n_shared = int(shared_ids.size)
        if n_shared and not (0 < shared_len <= int(length)):
            raise ValueError(
                f"shared_len {shared_len} must cover (0, length] — the "
                f"adopted prefix is part of this request's prompt")
        reserve = max(int(reserve) if reserve is not None else self.max_len,
                      s, int(length))
        n_total = self.pages.pages_for(reserve)
        if n_total > self.max_pages_per_slot:
            raise ValueError(
                f"reserve {reserve} needs {n_total} pages > "
                f"max_pages_per_slot {self.max_pages_per_slot}")
        n_data = max(self.pages.pages_for(s) - n_shared, 0)
        if ids is None:
            ids = self.pages.alloc(max(n_total - n_shared, n_data),
                                   tag=self._rid[slot])
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size < n_data:
            raise ValueError(f"pre-granted {ids.size} pages cannot hold the "
                             f"{n_data}-page private prefill remainder")
        self._place(slot, ids, shared_ids)
        ps = self.page_size
        start = min(n_shared * ps, s)
        dst = torch.from_numpy(ids[:n_data].astype(np.int64)).to(
            self.device)
        for (group, _, name, a), (_, _, _, r) in zip(
                cache_leaves(self.arena), cache_leaves(req_cache)):
            if name not in TIME_LEAVES:
                ax = 1 if group == "periods" else 0
                a[(slice(None),) * ax + (int(slot),)] = r.select(ax, 0).to(
                    a.dtype)
                continue
            if n_data:
                ax = a.dim() - 4            # the page axis: after periods
                r = r.select(ax, 0)         # drop batch 1; time now at ax
                r = r.narrow(ax, start, s - start)
                pad = list(r.shape)
                pad[ax] = n_data * ps - (s - start)
                r = torch.cat([r, r.new_zeros(pad)], dim=ax)
                r = r.reshape(r.shape[:ax] + (n_data, ps) + r.shape[ax + 1:])
                a[(slice(None),) * ax + (dst,)] = r.to(a.dtype)
        self.lens[int(slot)] = int(length)

    def assign(self, slot: int, ids: Optional[np.ndarray] = None,
               shared_ids: Optional[np.ndarray] = None,
               length: int = 0) -> None:
        """Place pre-granted pages (adopted ``shared_ids`` first) in
        ``slot``'s block table without writing any K/V (chunked-prefill
        admission: the coming chunk dispatches write the arena at the
        slot's cursor) and set its length — the adopted extent."""
        self._place(slot,
                    np.zeros(0, np.int32) if ids is None
                    else np.asarray(ids, np.int32).reshape(-1),
                    np.zeros(0, np.int32) if shared_ids is None
                    else np.asarray(shared_ids, np.int32).reshape(-1))
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

    # ------------------------------------------------------------ invariants
    def register_external_holder(self, fn) -> None:
        """Register a callable returning a ``{page_id: references}``
        multiset of pages held outside the block tables (the prefix
        cache's trie), for :meth:`check` to count."""
        self._external_holders.append(fn)

    def check(self) -> None:
        """Block tables and the page pool tell one story: every
        allocated page is mapped by exactly ``refcount`` slot rows plus
        its external holders' references."""
        self.pages.check()
        mult: Dict[int, int] = {}
        for fn in self._external_holders:
            for p, n in fn().items():
                mult[int(p)] = mult.get(int(p), 0) + int(n)
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
            assert rc == n, (f"page {p} mapped by {n} holder(s) but holds "
                             f"{rc} reference(s)")
