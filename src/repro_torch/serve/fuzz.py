"""Seeded lifecycle traces for the serving stack's randomized tests
(counterpart of ``repro.serve.fuzz``, over the port's own allocator and
prefix cache).

The §14 prefix cache adds a retained-reference lifecycle on top of the
§11 CoW refcount protocol, and example-based tests cannot cover the
interleavings that matter (donate-into-existing-branch while an adopter
is live, watermark eviction racing a re-adoption, cancel mid-prefill
with a shared head, ...). Following the progress-model-testing playbook
(randomized schedules driven against *declared invariants*, not
expected outputs), this module provides:

  * :func:`gen_trace` — a seeded generator of request traces (shared
    prompt pools, multi-turn follow-ups, cancellations) the fuzz tests
    drive engines with;
  * :class:`PoolFuzzHarness` — an engine-free, numpy-cheap lifecycle
    simulator over a real :class:`PagePool` + :class:`PrefixCache`,
    performing the exact allocator/cache call sequence the engine
    performs (reserve with adoption increfs + eviction decrefs, grow,
    retire-with-donation) and auditing the invariants after every
    round. Hundreds of seeds of this run inside tier-1.

Invariants audited (the declared properties, per round):
  I1  zero page leaks: free list + live holders partition the arena;
  I2  refcount >= 1 for every cache-held or table-referenced page, and
      every reference is accounted for (pool ``check`` + cache
      ``check``);
  I3  a shared (refcount > 1) page is never written by the simulated
      writers (write extents stay out of adopted prefixes);
  I4  FIFO grant order: the pool's grant log is a subsequence-respecting
      record of request admission order;
  I5  full drain (retire everything, drop the cache) leaves the pool
      empty.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.faults import FaultPlan, InjectedFault
from repro_torch.serve.kv_pages import PagePool
from repro_torch.serve.prefix_cache import PrefixCache, cache_key_suffix

__all__ = ["TraceEvent", "gen_trace", "drive_trace", "PoolFuzzHarness"]


# --------------------------------------------------------------- traces
@dataclasses.dataclass
class TraceEvent:
    """One submission in a generated trace."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    submit_round: int          # drive loop submits when its round reaches this
    cancel_after: Optional[int] = None   # rounds after submit, None = never
    turn_of: Optional[int] = None        # rid this prompt continues (info only)


def gen_trace(seed: int, *, n_requests: int = 8, vocab: int = 50,
              max_prompt: int = 24, max_new: int = 8,
              n_system_prompts: int = 2, p_shared: float = 0.5,
              p_multi_turn: float = 0.35, p_cancel: float = 0.15,
              arrival_spread: int = 6) -> List[TraceEvent]:
    """A seeded request trace with the collision structure the prefix
    cache exists for: a small pool of shared "system prompts" many
    requests start with, multi-turn follow-ups whose prompt is a prior
    request's prompt *plus its (unknown at generation time) reply* —
    represented here as prompt-extension placeholders the caller
    resolves — and randomized cancellations.

    Because a real multi-turn prompt depends on generated tokens, the
    returned events mark ``turn_of``: the caller (engine-level fuzz)
    must concatenate the parent's actual prompt+output when
    it submits. Engine-free consumers (the pool harness) treat the
    prompt array as-is. Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    systems = [rng.integers(1, vocab, size=int(rng.integers(
        max_prompt // 2, max_prompt))).astype(np.int32)
        for _ in range(n_system_prompts)]
    events: List[TraceEvent] = []
    for rid in range(n_requests):
        if events and rng.random() < p_multi_turn:
            parent = events[int(rng.integers(0, len(events)))]
            tail = rng.integers(1, vocab, size=int(
                rng.integers(1, 6))).astype(np.int32)
            prompt, turn_of = tail, parent.rid   # drive_trace prepends history
        else:
            turn_of = None
            if rng.random() < p_shared:
                head = systems[int(rng.integers(0, len(systems)))]
                tail = rng.integers(1, vocab, size=int(
                    rng.integers(0, 5))).astype(np.int32)
                prompt = np.concatenate([head, tail]).astype(np.int32)
            else:
                prompt = rng.integers(1, vocab, size=int(rng.integers(
                    2, max_prompt))).astype(np.int32)
        events.append(TraceEvent(
            rid=rid, prompt=prompt,
            max_new_tokens=int(rng.integers(1, max_new + 1)),
            submit_round=int(rng.integers(0, arrival_spread)),
            cancel_after=(int(rng.integers(1, 4))
                          if rng.random() < p_cancel else None),
            turn_of=turn_of))
    events.sort(key=lambda e: (e.submit_round, e.rid))
    return events


def drive_trace(eng, events, *, max_rounds: int = 5000,
                stats_out: Optional[Dict[str, int]] = None
                ) -> Dict[int, Dict[str, object]]:
    """Serve a :func:`gen_trace` against a ``SlotServeEngine``.

    Multi-turn events (``turn_of``) are resolved against the parent's
    *actual* prompt + generated reply — the submission is deferred until
    the parent finishes, so the child's prompt embeds the real
    conversation and exercises generated-prefix reuse. Cancellations
    fire ``cancel_after`` rounds after the submission.

    Returns ``{trace_rid: {"prompt", "out", "cancelled"}}``. Streams of
    requests that ran to completion are deterministic for a greedy
    engine, so two drives of the same trace (cache on vs off) must
    agree on every rid whose resolved prompt agrees and that neither
    run cancelled — the fuzz suite's bit-identity oracle. When
    ``stats_out`` is given, the scheduler-round count lands in it under
    ``"rounds"`` (the lock-ledger denominator).
    """
    pending = list(events)
    deferred: List[TraceEvent] = []
    cancels: List[Tuple[int, int]] = []        # (round, engine rid)
    live: Dict[int, int] = {}                  # engine rid -> trace rid
    out: Dict[int, Dict[str, object]] = {}
    round_no = 0
    while pending or deferred or eng.queue or eng.active:
        if round_no > max_rounds:
            raise AssertionError("trace did not drain (deadlock?)")

        def resolve(ev: TraceEvent) -> Optional[np.ndarray]:
            if ev.turn_of is None:
                return ev.prompt
            parent = out.get(ev.turn_of)
            if parent is None:
                return None                    # parent still in flight
            return np.concatenate(
                [np.asarray(parent["prompt"], np.int32),
                 np.asarray(parent["out"], np.int32),
                 ev.prompt]).astype(np.int32)

        still: List[TraceEvent] = []
        for ev in deferred:
            prompt = resolve(ev)
            if prompt is None:
                still.append(ev)
                continue
            req = eng.submit(prompt, ev.max_new_tokens)
            live[req.rid] = ev.rid
            out[ev.rid] = {"prompt": prompt, "out": [],
                           "cancelled": False, "_req": req}
            if ev.cancel_after is not None:
                cancels.append((round_no + ev.cancel_after, req.rid))
        deferred = still
        while pending and pending[0].submit_round <= round_no:
            ev = pending.pop(0)
            prompt = resolve(ev)
            if prompt is None:
                deferred.append(ev)
                continue
            req = eng.submit(prompt, ev.max_new_tokens)
            live[req.rid] = ev.rid
            out[ev.rid] = {"prompt": prompt, "out": [],
                           "cancelled": False, "_req": req}
            if ev.cancel_after is not None:
                cancels.append((round_no + ev.cancel_after, req.rid))
        for when, erid in list(cancels):
            if when <= round_no and erid in live:
                if eng.cancel(erid):
                    out[live[erid]]["cancelled"] = True
                cancels.remove((when, erid))
        eng.step()
        for erid, trid in list(live.items()):
            req = out[trid]["_req"]
            if req.state.terminal:
                out[trid]["out"] = list(req.out_tokens)
                out[trid]["cancelled"] = (out[trid]["cancelled"]
                                          or req.state.name != "FINISHED")
                del live[erid]
        round_no += 1
    for rec in out.values():
        rec.pop("_req", None)
    if stats_out is not None:
        stats_out["rounds"] = round_no
    return out


# ------------------------------------------------- pool-level lifecycle
@dataclasses.dataclass
class _SimSlot:
    rid: int
    tokens: np.ndarray         # full token budget (prompt ++ planned reply)
    prompt_len: int
    pages: List[int]           # table, position order
    epochs: List[int]
    shared: int                # adopted pages at the head (never written)
    written: int               # flat positions written so far


class PoolFuzzHarness:
    """Engine-free lifecycle fuzz over a real allocator + prefix cache.

    Simulates the engine's per-round call pattern against ``PagePool``
    and ``PrefixCache`` without any model or device work: admission
    looks the prompt up in the trie, increfs the adoption and grants
    the remainder in ONE ``alloc_batch`` (eviction decrefs riding the
    same call when the free list is short), decode rounds grow slots
    page by page, retirement donates full written pages and frees the
    rest in one ``free_batch``. After every round :meth:`check` audits
    the declared invariants. This is the shape the §14 protocol must
    keep safe under *any* interleaving — hundreds of seeded traces of
    it run in tier-1.
    """

    def __init__(self, seed: int, *, num_pages: int = 64,
                 page_size: int = 4, vocab: int = 40,
                 cache: bool = True, watermark_pages: int = 4,
                 faults: Optional[FaultPlan] = None):
        self.rng = np.random.default_rng(seed)
        self.page_size = page_size
        self.vocab = vocab
        self.pool = PagePool(num_pages, page_size)
        self.cache = (PrefixCache(page_size, self.pool)
                      if cache else None)
        self.watermark = watermark_pages
        #: deterministic mid-batch fault injection (DESIGN.md §15): the
        #: plan's ``alloc_hook`` fires inside the allocator's critical
        #: section; every abort must roll back atomically and the
        #: harness's invariants must keep holding — the chaos half of
        #: the fuzz suite
        self.faults = faults
        if faults is not None:
            self.pool.fault_hook = faults.alloc_hook
        self.aborts_recovered = 0
        self.slots: Dict[int, _SimSlot] = {}
        self.admit_order: List[int] = []       # rids in admission order
        self._retired_streams: List[np.ndarray] = []
        self.next_rid = 0
        self.rounds = 0
        # the one suffix a pool-level sim needs (no dispatch shapes)
        self.suffix = cache_key_suffix(0, 0)

    # ------------------------------------------------------------- admission
    def _pages_for(self, tokens: int) -> int:
        return self.pool.pages_for(tokens)

    def _suspended(self):
        return (self.faults.suspended() if self.faults is not None
                else contextlib.nullcontext())

    def _free_safe(self, groups) -> None:
        """``free_batch`` that recovers from an injected mid-batch
        abort: the undo log rolled it back, so the retry (injection
        suspended) applies the frees cleanly. Planned cache evictions
        MUST land this way — the trie already forgot those pages."""
        if not groups:
            return
        try:
            self.pool.free_batch(groups)
        except InjectedFault:
            self.aborts_recovered += 1
            with self._suspended():
                self.pool.free_batch(groups)

    def _make_prompt(self) -> np.ndarray:
        """Prompts drawn to collide: with probability ~1/2 extend a
        retired conversation (multi-turn reuse), else a fresh prompt
        over a tiny vocab (accidental prefix collisions likely)."""
        r = self.rng.random()
        if r < 0.5 and self.cache is not None and self.cache.pages_held:
            # replay a cached conversation prefix + a fresh tail: walk
            # the trie by re-generating a previously seen token stream
            # is overkill — instead remember streams as they retire
            if self._retired_streams:
                base = self._retired_streams[
                    int(self.rng.integers(0, len(self._retired_streams)))]
                tail = self.rng.integers(1, self.vocab, size=int(
                    self.rng.integers(1, 6))).astype(np.int32)
                return np.concatenate([base, tail])
        return self.rng.integers(1, self.vocab, size=int(
            self.rng.integers(2, 6 * self.page_size))).astype(np.int32)

    def admit(self) -> bool:
        """One admission: lookup → (maybe) eviction plan → ONE
        ``alloc_batch`` with incref + decref riders → table build."""
        prompt = self._make_prompt()
        new = int(self.rng.integers(1, 9))
        tokens = np.concatenate([prompt, self.rng.integers(
            1, self.vocab, size=new).astype(np.int32)])
        lp = prompt.size
        sh_len, sh_ids = 0, None
        if self.cache is not None:
            sh_len, sh_ids = self.cache.lookup(prompt, self.suffix)
            # never adopt the page the first write lands in: the engine
            # trims to < lp the same way (completion logits need a real
            # chunk; here it keeps I3 trivially auditable)
            max_keep = (lp - 1) // self.page_size
            if sh_len // self.page_size > max_keep:
                sh_ids = sh_ids[:max_keep]
                sh_len = max_keep * self.page_size
                if max_keep == 0:
                    sh_ids = None
        n_sh = 0 if sh_ids is None else int(sh_ids.size)
        need_now = self._pages_for(lp) - n_sh
        evict_groups: List[np.ndarray] = []
        if need_now > self.pool.n_free and self.cache is not None:
            evict_groups, _ = self.cache.evict_plan(
                need_now + self.watermark - self.pool.n_free)
        # only decrefs that actually free pages count: refcount 1 AND
        # not re-adopted by this same admission (the engine's
        # _evict_credit rule)
        adopt = set() if sh_ids is None else {int(p) for p in sh_ids}
        free_after = self.pool.n_free + sum(
            1 for g in evict_groups
            for p, r in zip(g.tolist(), self.pool.refcounts(g).tolist())
            if r == 1 and int(p) not in adopt)
        if need_now > free_after:
            # cannot admit: planned evictions still MUST land
            if evict_groups:
                self._free_safe(evict_groups)
            return False
        rid = self.next_rid
        self.next_rid += 1
        try:
            ids = self.pool.alloc_batch(
                [need_now], [rid],
                incref_groups=[sh_ids] if n_sh else None,
                decref_groups=evict_groups or None)[0]
        except InjectedFault:
            # aborted mid-batch: the undo log rolled the grant, the
            # adoption increfs, AND the eviction decrefs back. The
            # admission simply fails this round; the evictions are
            # re-applied under suspended injection.
            self.aborts_recovered += 1
            self.pool.check()
            self._free_safe(evict_groups)
            return False
        pages = ([] if sh_ids is None else
                 [int(p) for p in sh_ids]) + [int(p) for p in ids]
        self.slots[rid] = _SimSlot(
            rid=rid, tokens=tokens, prompt_len=lp, pages=pages,
            epochs=self.pool.epochs(pages).tolist(),
            shared=n_sh, written=lp)
        self.admit_order.append(rid)
        return True

    # ---------------------------------------------------------------- rounds
    def decode_round(self) -> None:
        """Every live slot writes one more position (growing by a page
        through ``alloc_batch`` when it crosses a boundary — eviction
        riding the same call under the watermark), then some retire."""
        grow_counts, grow_rids = [], []
        for rid, s in sorted(self.slots.items()):
            if s.written >= s.tokens.size:
                continue
            if s.written + 1 > len(s.pages) * self.page_size:
                grow_counts.append(1)
                grow_rids.append(rid)
        if grow_counts:
            evict_groups: List[np.ndarray] = []
            if (self.cache is not None
                    and self.pool.n_free < len(grow_counts) + self.watermark):
                evict_groups, _ = self.cache.evict_plan(
                    len(grow_counts) + self.watermark - self.pool.n_free)
            try:
                grants = self.pool.alloc_batch(
                    grow_counts, [("grow", r) for r in grow_rids],
                    partial=True, decref_groups=evict_groups or None)
            except InjectedFault:
                # aborted mid-batch: no slot grows this round (their
                # writes stall exactly like an engine pause); the
                # planned evictions still land
                self.aborts_recovered += 1
                self.pool.check()
                self._free_safe(evict_groups)
                grants = [None] * len(grow_counts)
            for rid, ids in zip(grow_rids, grants):
                if ids is not None:
                    s = self.slots[rid]
                    s.pages.extend(int(p) for p in ids)
                    s.epochs.extend(self.pool.epochs(ids).tolist())
        for rid, s in sorted(self.slots.items()):
            if s.written < s.tokens.size \
                    and s.written + 1 <= len(s.pages) * self.page_size:
                # I3 audit at the write site: the engine's invariant is
                # "a shared page is never written" — adopted pages all
                # precede the write cursor by construction, and a page
                # the CACHE holds may be written only if this slot is
                # its sole table holder *and* the cache's copy is the
                # same physical page it donated... which cannot happen:
                # cache-held pages have refcount >= 1 from the cache
                # alone, so a writable page here must be refcount 1.
                page = s.pages[s.written // self.page_size]
                rc = int(self.pool.refcounts([page])[0])
                assert rc == 1, (
                    f"simulated write to page {page} with refcount {rc} "
                    f"(shared pages must never be written)")
                s.written += 1
        self.rounds += 1

    def retire_some(self, p_retire: float = 0.4) -> None:
        """Retire finished (and randomly, unfinished = cancelled)
        slots: donate written full pages, free the rest in ONE
        ``free_batch`` — the engine's deferred-free retirement."""
        groups: List[np.ndarray] = []
        for rid in list(self.slots):
            s = self.slots[rid]
            done = s.written >= s.tokens.size
            cancel = self.rng.random() < p_retire * 0.3
            if not done and not cancel and self.rng.random() > p_retire:
                continue
            if not done and not cancel:
                continue
            del self.slots[rid]
            held = np.asarray(s.pages, np.int32)
            if self.cache is not None and s.written >= self.page_size:
                kept, _dup = self.cache.donate(
                    s.tokens[:s.written], held, self.suffix,
                    generated_from=s.prompt_len)
                if kept.size:
                    held = held[~np.isin(held, kept)]
                self._retired_streams.append(s.tokens[:s.written].copy())
                if len(self._retired_streams) > 8:
                    self._retired_streams.pop(0)
            if held.size:
                groups.append(held)
        if groups:
            self._free_safe(groups)

    # ------------------------------------------------------------ invariants
    def check(self) -> None:
        """Audit I1/I2/I4 (I3 is audited at each simulated write; I5 by
        :meth:`drain`)."""
        # I2: every reference accounted for — table rows + cache holders
        mult: Dict[int, int] = {}
        for s in self.slots.values():
            assert self.pool.entry_valid(
                np.asarray(s.pages, np.int32),
                np.asarray(s.epochs, np.int64)), \
                f"slot {s.rid} table names a recycled page"
            for p in s.pages:
                mult[p] = mult.get(p, 0) + 1
        if self.cache is not None:
            self.cache.check()
            for p, n in self.cache.holders().items():
                mult[p] = mult.get(p, 0) + n
        allocated = set(np.flatnonzero(self.pool._allocated).tolist())
        # I1: no leaks — every allocated page has a holder, every held
        # page is allocated
        assert set(mult) == allocated, (
            sorted(set(mult) ^ allocated),
            "allocated pages and holders disagree (leak or dangler)")
        for p, n in mult.items():
            rc = int(self.pool._refcount[p])
            assert rc == n and rc >= 1, (p, rc, n, "refcount drift")
        self.pool.check()
        # I4: FIFO grant order — the allocator's grant log, filtered to
        # this harness's admission tags, respects admission order
        granted = [t for t in self.pool.grant_log if isinstance(t, int)]
        admitted = [r for r in self.admit_order if r in set(granted)]
        assert granted == admitted, (granted, admitted,
                                     "grant log broke FIFO order")

    def drain(self) -> None:
        """I5: retire everything, drop the cache, assert empty pool."""
        while self.slots:
            for s in self.slots.values():
                s.written = s.tokens.size
            self.retire_some(p_retire=1.0)
        if self.cache is not None:
            groups = self.cache.drop_all()
            if groups:
                self._free_safe(groups)
        assert self.pool.in_use == 0, (
            f"{self.pool.in_use} pages leaked after full drain")
        self.pool.check()

    # ----------------------------------------------------------------- drive
    def run(self, rounds: int = 40) -> None:
        for _ in range(rounds):
            if self.rng.random() < 0.7:
                self.admit()
            self.decode_round()
            self.retire_some()
            self.check()
        self.drain()
