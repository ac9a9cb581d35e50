"""Slot-based continuous batching behind the Algorithm-5 semaphore
(counterpart of ``repro.serve.engine.SlotServeEngine``, the serving
main path's configuration).

One engine replica owns K slots over a paged KV arena
(``serve/kv_pages.py``) and runs scheduler rounds:

  * **admission** — the library's windowed Algorithm-5 planner (the
    CUDA semaphore kernel on a card) is replanned every round over the
    in-flight holds plus the queued front; a queued request is admitted
    iff the timeline grants it with ``waited == 0`` *now*. The host
    ``AdmissionController`` (a live sleeping semaphore) is the occupancy
    gate and ``grant_log`` records the FIFO grant order. Admission is
    bookkeeping only (chunked prefill): a slot, pages for the first
    chunk(s) under one ticket-mutex critical section, and a cursor;
  * **page prep** — lazy growth: one critical section tops up every
    decoding slot and every planned chunk; a starved slot pauses for the
    round, and if nobody can advance the youngest grant is preempted
    back to the queue (greedy decoding regenerates its stream);
  * **dispatch** — ``decode_chunk`` decode steps over the active rows
    (gathered into a power-of-2 bucket when bucketed dispatch is on),
    *then* a ``C``-token prefill chunk for the FIFO-oldest prefilling
    rows. The order matters: a prefilling row's frozen decode steps
    write scratch K/V where the chunk writes, so the chunk must land
    after them;
  * **retirement** — every finished row's pages return in one
    ``free_batch``.

Decoding is greedy. Outside this slice — and raising "not ported yet"
at construction rather than silently dropping anything: the contiguous
slot layout, one-shot prefill, sampling, eager page growth, prefix
sharing, the prefix cache, fault injection, cancellation and deadlines.

The reference relies on JAX's dropping scatters at three places; the
port masks lanes out *before* each scatter instead: the ``_DROP_POS``
write sentinel and sentinel pages (``models.attention.page_write_plan``)
and the bucket round's scatter-back to row ``K`` (only live bucket lanes
are written back, see ``_bucket_round``).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.serve.dispatch import DecodeDispatchCache
from repro_torch.serve.kv_pages import PagedSlotPool
from repro_torch.serve.scheduler import (AdmissionController,
                                         allocator_contention, plan_round)
from repro_torch.sync import SyncLibrary

#: Write-drop sentinel for chunked prefill: pad lanes of a partial last
#: chunk and rows not advancing this round carry it as their write
#: position. Large and positive — past any block table, so the masked
#: scatter leaves it out.
_DROP_POS = 2 ** 30


class RequestState(str, enum.Enum):
    """QUEUED → PREFILLING → DECODING → FINISHED. A lazy-growth
    preemption moves a request back to QUEUED (restart, not
    termination)."""
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class ServeRequest:
    """One request's lifecycle (step-clock timestamps are in decode-step
    units; ``*_s`` are wall-clock seconds)."""
    rid: int
    prompt: np.ndarray                 # [L] int32 token ids
    max_new_tokens: int
    arrival_step: int = 0
    arrival_s: float = 0.0
    grant_step: int = -1
    grant_s: float = 0.0
    finish_step: int = -1
    finish_s: float = 0.0
    slot: int = -1
    eos: bool = False
    state: RequestState = RequestState.QUEUED
    decode_start_step: int = -1
    preemptions: int = 0
    prefill_chunks: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def wait_steps(self) -> int:
        return self.grant_step - self.arrival_step

    @property
    def wait_s(self) -> float:
        return self.grant_s - self.arrival_s

    @property
    def queued_steps(self) -> int:
        end = self.grant_step if self.grant_step >= 0 else self.finish_step
        return max(end - self.arrival_step, 0)

    @property
    def prefill_steps(self) -> int:
        if self.grant_step < 0 or self.decode_start_step < 0:
            return 0
        return max(self.decode_start_step - self.grant_step, 0)

    @property
    def decode_steps(self) -> int:
        if self.decode_start_step < 0 or self.finish_step < 0:
            return 0
        return max(self.finish_step - self.decode_start_step, 0)


def _not_ported(what: str):
    raise ValueError(f"{what} is not ported yet")


class SlotServeEngine:
    """Continuous-batching engine over a paged KV slot arena.

    Drive it with ``submit`` + ``run_until_done``, or ``step`` from an
    outer loop. Runs on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``params`` must live there.
    ``attention_impl="fused"`` decodes through the fused paged-decode
    kernel, ``"gather"`` through gather-then-attend.
    """

    def __init__(self, model, params, *, capacity: int, max_len: int,
                 temperature: float = 0.0, decode_chunk: int = 1,
                 eos_id: Optional[int] = None,
                 use_admission_kernel: bool = True,
                 plan_window: int = 64,
                 kv_layout: str = "paged",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 page_growth: str = "lazy",
                 admit_headroom: float = 0.1,
                 page_lookahead_chunks: int = 2,
                 allocator_wait: Optional[str] = None,
                 prefix_sharing: str = "off",
                 prefix_cache: str = "off",
                 prefill_chunk_tokens: Optional[int] = None,
                 round_token_budget: Optional[int] = None,
                 fault_plan=None,
                 attention_impl: str = "gather",
                 bucketed_dispatch: str = "auto",
                 sync: Optional[SyncLibrary] = None,
                 device=None):
        if kv_layout != "paged":
            _not_ported(f"kv_layout={kv_layout!r} (the contiguous slot "
                        f"arena)")
        if temperature > 0.0:
            _not_ported("sampling (temperature > 0)")
        if not prefill_chunk_tokens:
            _not_ported("one-shot prefill (pass prefill_chunk_tokens)")
        if page_growth != "lazy":
            _not_ported(f"page_growth={page_growth!r}")
        if prefix_sharing != "off":
            _not_ported("prefix sharing (pass prefix_sharing='off')")
        if prefix_cache != "off":
            _not_ported("the prefix cache")
        if fault_plan is not None:
            _not_ported("fault injection")
        if capacity < 1 or decode_chunk < 1:
            raise ValueError("capacity and decode_chunk must be >= 1")
        if int(prefill_chunk_tokens) < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        if attention_impl not in ("gather", "fused"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}; "
                             f"expected gather or fused")
        if bucketed_dispatch not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown bucketed_dispatch {bucketed_dispatch!r}; "
                f"expected auto, on, or off")
        self.device = resolve_device(device)
        emb = params["embed"]["tokens"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self.params = params
        self.capacity = capacity
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.eos_id = eos_id
        self.attention_impl = attention_impl
        self.sync = sync if sync is not None else SyncLibrary.host_default()
        # the planning trace holds all K in-flight requests plus the
        # queued front; a window below capacity would cap concurrency
        self.plan_window = max(plan_window, 2 * capacity)
        # greedy, paged, attention-only: every condition the reference
        # gates bucketing on holds in this slice
        self.bucketed_dispatch = bucketed_dispatch in ("auto", "on")
        self._dispatch_cache = (DecodeDispatchCache(capacity)
                                if self.bucketed_dispatch else None)
        self.prefill_chunk = int(prefill_chunk_tokens)
        self.round_token_budget = (
            int(round_token_budget) if round_token_budget
            else capacity * (decode_chunk + self.prefill_chunk))
        self.admit_headroom = float(admit_headroom)
        self.page_lookahead_chunks = max(int(page_lookahead_chunks), 1)
        self.pool = PagedSlotPool(
            model, capacity, max_len, page_size=page_size,
            num_pages=num_pages, max_pages_per_slot=max_pages_per_slot,
            sync=self.sync, wait_mode=allocator_wait,
            expected_contention=allocator_contention(
                capacity, service_steps=float(max_len)),
            device=self.device)
        self.admission = AdmissionController(capacity, lib=self.sync)
        self._admission_planner = (
            self.sync.semaphore_planner(capacity, window=self.plan_window,
                                        device=self.device)
            if use_admission_kernel else None)
        self.queue: Deque[ServeRequest] = collections.deque()
        self.active: Dict[int, ServeRequest] = {}      # slot -> request
        self.finished: List[ServeRequest] = []
        self.grant_log: List[int] = []                 # rids in grant order
        self.step_clock = 0
        self.decode_dispatches = 0
        self.decode_steps_run = 0   # model decode steps (each: every layer)
        self.pauses = 0
        self.preemptions = 0
        self.prefill_tokens = 0
        self.pad_tokens = 0
        self.prefill_chunks = 0
        self._next_rid = 0
        self._last_tok = np.zeros(capacity, np.int32)
        self._steps_left = np.zeros(capacity, np.int64)
        # chunked-prefill cursor per slot: prefilling while pos < end
        self._pf_pos = np.zeros(capacity, np.int64)
        self._pf_end = np.zeros(capacity, np.int64)
        # lazy top-up cap: the flat positions the request can touch
        self._grow_cap = np.zeros(capacity, np.int64)

    # ------------------------------------------------------------ submission
    def submit(self, prompt, max_new_tokens: int, rid: Optional[int] = None,
               deadline_step: Optional[int] = None,
               deadline_s: Optional[float] = None) -> ServeRequest:
        """Queue a request (deadlines are not ported yet)."""
        if deadline_step is not None or deadline_s is not None:
            _not_ported("request deadlines")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens + 1 > self.pool.virtual_max_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new_tokens}) "
                f"exceeds slot max_len({self.pool.virtual_max_len})")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = ServeRequest(rid=rid, prompt=prompt,
                           max_new_tokens=max_new_tokens,
                           arrival_step=self.step_clock,
                           arrival_s=time.perf_counter())
        self.queue.append(req)
        return req

    def cancel(self, rid: int) -> bool:
        _not_ported("cancellation")

    # ------------------------------------------------------------- admission
    def _planned_admit_count(self) -> int:
        """How many FIFO-front queued requests the Algorithm-5 timeline
        grants *now*, given the in-flight holds. The trace is built in
        Python floats, then cast to float32 — exactly the reference's,
        so the grant decisions agree to the bit."""
        n_queued = len(self.queue)
        if n_queued == 0:
            return 0
        if self._admission_planner is None:
            return min(self.pool.n_free, n_queued)
        now = float(self.step_clock)
        act = sorted(self.active)
        arr = ([now] * len(act)
               + [now + 1e-3 * (i + 1) for i in range(n_queued)])
        hold = ([float(max(self._steps_left[s], 1)) for s in act]
                + [float(r.max_new_tokens) for r in self.queue])
        n_plan = min(len(arr), self.plan_window)
        _, _, waited = self._admission_planner(
            np.asarray(arr[:n_plan], np.float32),
            np.asarray(hold[:n_plan], np.float32))
        n_admit = 0
        for w in waited[len(act):]:       # FIFO prefix granted now
            if w:
                break
            n_admit += 1
        return n_admit

    def _headroom_pages(self) -> int:
        return int(np.ceil(self.admit_headroom * self.pool.pages.num_pages))

    def _admit(self) -> int:
        """Chunked admission: pure bookkeeping, no model dispatch. The
        page grant is tiered — the whole prompt plus the decode
        lookahead when pages allow, else a chunk-lookahead window, else
        the first chunk — and one allocator critical section covers the
        whole batch."""
        n_admit = self._planned_admit_count()
        staged = []                      # (req, slot, lp, grant)
        staged_pages = 0
        C = self.prefill_chunk
        look = self.page_lookahead_chunks
        while len(staged) < n_admit and self.queue and self.pool.n_free:
            req = self.queue[0]
            lp = int(req.prompt.size)
            need = max(lp + req.max_new_tokens - 1, lp)
            reserve = lp + req.max_new_tokens + 1
            first = min(C, need)
            window = min(C * look, need)
            generous = min(max(lp, first) + self.decode_chunk * look, need)
            grant = next(
                (g for g in (generous, window, first)
                 if self.pool.can_admit_lazy(
                     g, reserve, headroom_pages=self._headroom_pages(),
                     pending_pages=staged_pages)), None)
            if grant is None:
                break
            self.queue.popleft()
            # Algorithm-5 wait(): never blocks — the planner only granted
            # as many requests as there are free slots
            if not self.admission.acquire_slot(timeout=5.0):
                self.queue.appendleft(req)
                break
            slot = self.pool.acquire(req.rid)
            staged.append((req, slot, lp, grant))
            staged_pages += self.pool.pages.pages_for(grant)
        if not staged:
            return 0
        grants = self.pool.reserve_batch(
            [(slot, grant) for (_, slot, _, grant) in staged])
        for (req, slot, lp, _), ids in zip(staged, grants):
            self.pool.assign(slot, ids=ids, length=0)
            self._pf_pos[slot] = 0
            self._pf_end[slot] = lp
            self._last_tok[slot] = 0
            self._steps_left[slot] = req.max_new_tokens - 1
            self._grow_cap[slot] = max(lp + req.max_new_tokens - 1, lp)
            req.slot = slot
            if req.preemptions == 0 or req.grant_step < 0:
                # a preempted request keeps its first grant's log entry
                req.grant_step = self.step_clock
                req.grant_s = time.perf_counter()
                self.grant_log.append(req.rid)
            req.state = RequestState.PREFILLING
            self.active[slot] = req
        return len(staged)

    def _retire_batch(self, pairs: List[Tuple[int, int]]) -> None:
        """Retire ``(slot, step_offset)`` pairs; every retirement's pages
        return in ONE allocator critical section."""
        deferred = []
        for slot, offset in pairs:
            req = self.active.pop(slot)
            req.state = RequestState.FINISHED
            req.finish_step = self.step_clock + offset
            req.finish_s = time.perf_counter()
            self._steps_left[slot] = 0
            held = self.pool.evict(slot)
            if held.size:
                deferred.append(held)
            self.admission.release_slot()
            self.finished.append(req)
        if deferred:
            self.pool.pages.free_batch(deferred)

    # --------------------------------------------------- lazy page growth
    def _preempt(self, slot: int) -> None:
        """Lazy-overflow eviction: the victim's pages return now and it
        goes back to the queue front, to restart from its prompt (greedy
        decoding regenerates the same stream; its first grant keeps the
        FIFO log entry)."""
        req = self.active.pop(slot)
        held = self.pool.evict(slot)
        if held.size:
            self.pool.pages.free_batch([held])
        self.admission.release_slot()
        self._steps_left[slot] = 0
        self._grow_cap[slot] = 0
        self._pf_pos[slot] = 0
        self._pf_end[slot] = 0
        req.slot = -1
        req.state = RequestState.QUEUED
        req.eos = False
        req.out_tokens = []
        req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(req)

    def _prefilling(self, slot: int) -> bool:
        return self._pf_pos[slot] < self._pf_end[slot]

    def _grow_for_chunk(self, steps: int, chunk_rows: Tuple[int, ...] = ()
                        ) -> Tuple[set, set]:
        """The per-round page prep: ONE allocator critical section tops
        up every decoding slot (to the pages this round's writes and
        reads need, a lookahead window ahead, capped at its worst case)
        and every planned prefill chunk. A decoding slot that cannot be
        covered pauses for the round; a chunk whose pages starve is
        deferred whole. If nobody can advance, the youngest grant is
        preempted until someone can. Returns ``(paused_decode_slots,
        advancing_chunk_slots)``."""
        chunk_set = set(chunk_rows)
        if not self.active:
            return set(), chunk_set
        C = self.prefill_chunk
        ps = self.pool.page_size
        lens = self.pool.lens_numpy()
        order = sorted(self.active, key=lambda s: self.active[s].rid)
        while order:
            decode_live = [s for s in order if not self._prefilling(s)]
            chunk_live = [s for s in order if s in chunk_set]
            tight = self.pool.pages.n_free <= self._headroom_pages()
            look = 1 if tight else self.page_lookahead_chunks
            items = []
            for s in order:
                if self._prefilling(s):
                    if s not in chunk_set:
                        continue      # deferred rows need no pages
                    target = min(int(self._pf_pos[s]) + C * look,
                                 int(self._pf_end[s]))
                else:
                    target = int(min(lens[s] + steps * look,
                                     self._grow_cap[s]))
                items.append((s, target))
            self.pool.grow_batch(items)
            paused = {s for s in decode_live
                      if self.pool.held_pages(s) * ps
                      < min(lens[s] + steps, self._grow_cap[s])}
            starved = {s for s in chunk_live
                       if self.pool.held_pages(s) * ps
                       < min(int(self._pf_pos[s]) + C, int(self._pf_end[s]))}
            if not decode_live and not chunk_live:
                return paused, set()
            if len(paused) < len(decode_live) or len(starved) < len(
                    chunk_live):
                self.pauses += len(paused)
                return paused, chunk_set - starved
            victim = max(order, key=lambda s: self.active[s].rid)
            self._preempt(victim)
            order.remove(victim)
            chunk_set.discard(victim)
            lens = self.pool.lens_numpy()
        return set(), set()

    # ------------------------------------------------------------- dispatch
    def _decode_scan(self, cache, last_tok, frozen, steps):
        """``steps`` batched greedy decode steps. Frozen rows keep their
        last token (their cache writes are scratch); eos freezes a row
        for the rest of the chunk."""
        tok, toks = last_tok, []
        for _ in range(steps):
            logits, cache = self.model.decode_step(
                self.params, cache, tok, attn_impl=self.attention_impl)
            self.decode_steps_run += 1
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(frozen, tok, nxt)
            if self.eos_id is not None:
                frozen = frozen | (nxt == self.eos_id)
            tok = nxt
            toks.append(nxt)
        return cache, tok, torch.stack(toks)               # [steps, B]

    def _round(self, cache, last_tok, frozen, pf_tok, pf_qpos, pf_wpos,
               steps, chunk):
        """The decode scan FIRST, then the optional prefill chunk — the
        chunk's writes must overwrite the scratch K/V that the frozen
        prefilling rows' decode steps wrote at their cursor."""
        cache, tok, toks = self._decode_scan(cache, last_tok, frozen, steps)
        pf_logits = None
        if chunk:
            pf_logits, cache = self.model.prefill_chunk(
                self.params, cache, pf_tok, pf_qpos, pf_wpos)
        return cache, tok, toks, pf_logits

    def _bucket_round(self, cache, rows: np.ndarray, last_tok, frozen,
                      pf_tok, pf_qpos, pf_wpos, steps, chunk):
        """The round over a ``[kb]``-row gather of the active slots. Pad
        lanes (row id == K) are inert: length 0, sentinel table row,
        frozen, ``_DROP_POS`` writes — and only the live lanes are
        scattered back (the reference drops the pad lanes' scatter-back
        at the out-of-range row ``K``)."""
        K = self.capacity
        self._dispatch_cache.record_shape(("round", len(rows), steps, chunk))
        live = np.flatnonzero(rows < K)
        dev = self.device
        r = torch.from_numpy(np.minimum(rows, K - 1).astype(np.int64)).to(dev)
        pad = torch.from_numpy(rows >= K).to(dev)
        cache_b = dict(cache)
        cache_b["len"] = torch.where(pad, 0, cache["len"][r])
        cache_b["pages"] = torch.where(
            pad[:, None], self.pool.pages.num_pages, cache["pages"][r])
        out_b = self._round(
            cache_b, torch.where(pad, 0, last_tok[r]), frozen[r] | pad,
            pf_tok[r], pf_qpos[r],
            torch.where(pad[:, None], _DROP_POS, pf_wpos[r]), steps, chunk)
        cache_o, tok_b, toks_b, pf_logits_b = out_b
        src = torch.from_numpy(live).to(dev)
        dst = torch.from_numpy(rows[live].astype(np.int64)).to(dev)
        out = dict(cache_o)
        out["len"] = cache["len"].clone()
        out["len"][dst] = cache_o["len"][src]
        out["pages"] = cache["pages"]
        tok = last_tok.clone()
        tok[dst] = tok_b[src]
        toks = last_tok[None, :].expand(steps, K).clone()
        toks[:, dst] = toks_b[:, src]
        pf_logits = None
        if chunk:
            pf_logits = torch.zeros((K,) + tuple(pf_logits_b.shape[1:]),
                                    dtype=pf_logits_b.dtype, device=dev)
            pf_logits[dst] = pf_logits_b[src]
        return out, tok, toks, pf_logits

    # ------------------------------------------------------------ decode loop
    def step(self) -> int:
        """One scheduler round: re-tune the allocator's wait strategy,
        admit per the Algorithm-5 plan, prepare pages, dispatch, retire.
        Returns the number of still-active requests."""
        self.pool.retune()
        self._admit()
        if not self.active:
            return 0
        return self._run_round()

    def _run_round(self) -> int:
        steps = self.decode_chunk
        C = self.prefill_chunk
        backlog = sorted((s for s in self.active if self._prefilling(s)),
                         key=lambda s: self.active[s].rid)
        decode_rows = [s for s in self.active if not self._prefilling(s)]
        planned = plan_round(
            self.round_token_budget, decode_rows, backlog, chunk_tokens=C,
            decode_chunk=steps,
            remaining={s: int(self._pf_end[s] - self._pf_pos[s])
                       for s in backlog}).chunk_rows
        paused, advancing = self._grow_for_chunk(steps, tuple(planned))
        if not self.active:                    # everything preempted away
            return 0
        chunk_rows = [s for s in planned
                      if s in advancing and s in self.active]
        pf_rows = [s for s in self.active if self._prefilling(s)]
        frozen = np.ones(self.capacity, bool)
        for slot in self.active:
            if slot not in paused and not self._prefilling(slot):
                frozen[slot] = False
        lens_before = self.pool.lens_numpy() if paused else None
        view = self.pool.cache_view()
        if paused:
            # paused rows must not touch the arena this round
            view["pages"] = self.pool.masked_table(paused)
        pf_tok = np.zeros((self.capacity, C), np.int32)
        pf_qpos = np.zeros((self.capacity, C), np.int32)
        pf_wpos = np.full((self.capacity, C), _DROP_POS, np.int32)
        valid: Dict[int, int] = {}
        for s in chunk_rows:
            p0 = int(self._pf_pos[s])
            v = int(min(C, self._pf_end[s] - p0))
            pf_tok[s, :v] = self.active[s].prompt[p0:p0 + v]
            pf_qpos[s, :] = p0 + np.arange(C)
            pf_wpos[s, :v] = p0 + np.arange(v)
            valid[s] = v
        dev = self.device
        args = (view, torch.from_numpy(self._last_tok).to(dev),
                torch.from_numpy(frozen).to(dev),
                torch.from_numpy(pf_tok).to(dev),
                torch.from_numpy(pf_qpos).to(dev),
                torch.from_numpy(pf_wpos).to(dev))
        chunk = C if chunk_rows else 0
        if self.bucketed_dispatch:
            # every active slot rides the bucket (prefilling and paused
            # rows too: the decode-then-chunk ordering needs their lanes);
            # vacant slots stay out
            kb = self._dispatch_cache.bucket(len(self.active))
            rows = self._dispatch_cache.pad_rows(sorted(self.active), kb)
            cache, tok, toks, pf_logits = self._bucket_round(
                args[0], rows, *args[1:], steps, chunk)
        else:
            cache, tok, toks, pf_logits = self._round(*args, steps, chunk)
        self.decode_dispatches += 1
        self.pool.adopt(cache)
        self._last_tok = tok.cpu().numpy().astype(np.int32)
        toks = toks.cpu().numpy()                          # [steps, K]

        completions: List[Tuple[int, int]] = []
        for s in chunk_rows:
            v = valid[s]
            self._pf_pos[s] += v
            self.prefill_chunks += 1
            self.prefill_tokens += v
            self.pad_tokens += C - v
            self.active[s].prefill_chunks += 1
            if self._pf_pos[s] >= self._pf_end[s]:
                completions.append((s, v))
        if paused or pf_rows:
            # roll lengths back: paused rows to before the dispatch,
            # prefilling rows to their cursor (their decode-scan scratch
            # is rewritten before anything reads it)
            lens = self.pool.lens_numpy()
            for s in pf_rows:
                lens[s] = int(self._pf_pos[s])
            if paused:
                idx = list(paused)
                lens[idx] = lens_before[idx]
            self.pool.set_lens(torch.from_numpy(lens.astype(np.int32)))

        retire: List[Tuple[int, int]] = []
        pf_skip = set(pf_rows)
        for s, v in completions:
            # prompt fully cached: the first output token comes from the
            # chunk's last real lane (prefilling -> decoding)
            req = self.active[s]
            tok0 = int(torch.argmax(pf_logits[s, v - 1]))
            self._last_tok[s] = tok0
            req.out_tokens.append(tok0)
            if self.eos_id is not None and tok0 == self.eos_id:
                req.eos = True
            self._pf_pos[s] = 0
            self._pf_end[s] = 0
            req.state = RequestState.DECODING
            req.decode_start_step = self.step_clock
            if req.eos or self._steps_left[s] <= 0:
                retire.append((s, 0))
        for slot in list(self.active):
            if slot in paused or slot in pf_skip:
                continue
            req = self.active[slot]
            done_at = None
            for s in range(steps):
                if self._steps_left[slot] <= 0:
                    break
                t = int(toks[s, slot])
                req.out_tokens.append(t)
                self._steps_left[slot] -= 1
                if self.eos_id is not None and t == self.eos_id:
                    req.eos = True
                    done_at = s + 1
                    break
                if self._steps_left[slot] <= 0:
                    done_at = s + 1
            if done_at is not None:
                retire.append((slot, done_at))
        self._retire_batch(retire)
        self.step_clock += steps
        return len(self.active)

    def run_until_done(self, max_rounds: int = 1_000_000) -> int:
        """Drain queue + active set. Returns scheduler rounds used."""
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            self.step()
            rounds += 1
        return rounds

    # -------------------------------------------------------------- reporting
    def stats(self) -> Dict[str, float]:
        """Aggregate serving counters (the reference's keys that this
        slice fills; all floats)."""
        term = self.finished
        granted = [r for r in term if r.grant_step >= 0]
        waits = np.asarray([r.wait_steps for r in granted], np.float32)
        waits_s = np.asarray([r.wait_s for r in granted], np.float32)
        toks = int(sum(len(r.out_tokens) for r in term))

        def pctl(vals, q):
            arr = np.asarray(vals, np.float32)
            return float(np.percentile(arr, q)) if arr.size else 0.0

        pp = self.pool.pages
        ls = pp.lock_stats()
        return {
            "finished": float(len(term)),
            "tokens": float(toks),
            "decode_dispatches": float(self.decode_dispatches),
            "decode_steps": float(self.decode_steps_run),
            "p50_wait_steps": pctl(waits, 50),
            "p99_wait_steps": pctl(waits, 99),
            "p50_wait_s": pctl(waits_s, 50),
            "p99_wait_s": pctl(waits_s, 99),
            "queue_depth": float(len(self.queue)),
            "active_rows": float(len(self.active)),
            "p99_queued_steps": pctl([r.queued_steps for r in granted], 99),
            "p99_prefill_steps": pctl([r.prefill_steps for r in granted],
                                      99),
            "p99_decode_steps": pctl([r.decode_steps for r in granted], 99),
            "semaphore_admitted": float(self.admission.admitted),
            "semaphore_completed": float(self.admission.completed),
            "prefill_chunk_tokens": float(self.prefill_chunk),
            "round_token_budget": float(self.round_token_budget),
            "prefill_tokens": float(self.prefill_tokens),
            "pad_tokens": float(self.pad_tokens),
            "pad_fraction": (float(self.pad_tokens)
                             / float(max(self.prefill_tokens
                                         + self.pad_tokens, 1))),
            "prefill_chunks": float(self.prefill_chunks),
            "attention_fused": float(self.attention_impl == "fused"),
            "bucketed_dispatch": float(self.bucketed_dispatch),
            "dispatch_shapes": float(len(self._dispatch_cache.shapes)
                                     if self._dispatch_cache else 0),
            "page_allocs": float(pp.allocs),
            "page_frees": float(pp.frees),
            "pages_peak_in_use": float(pp.peak_in_use),
            "pages_total": float(pp.num_pages),
            "page_pauses": float(self.pauses),
            "page_preemptions": float(self.preemptions),
            # the paper's currency: synchronizing ops on the allocator
            # per unit of useful work
            "lock_acquires": float(ls["acquires"]),
            "lock_contended_acquires": float(ls["contended_acquires"]),
            "lock_held_s": float(ls["held_s"]),
            "lock_acquires_per_token": (float(ls["acquires"])
                                        / float(max(toks, 1))),
            "lock_retunes": float(ls.get("retunes", 0)),
            "per_page_lock_acquires_per_token": (
                float(pp.pages_alloced + pp.pages_freed)
                / float(max(toks, 1))),
        }
