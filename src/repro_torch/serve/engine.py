"""Serving engines: the legacy per-request loop and slot-based continuous
batching behind the Algorithm-5 semaphore (counterpart of
``repro.serve.engine``: ``ServeEngine`` and ``SlotServeEngine``).

``ServeEngine`` is the reference's baseline: one whole-prompt prefill,
then a Python decode loop over the batch (greedy), no slot reuse and no
admission. ``SlotServeEngine`` owns K slots over a KV arena — the
contiguous ``[K, max_len]`` slot layout (``serve/kv_slots.py``, the
reference's default) or the paged arena (``serve/kv_pages.py``) — and
runs scheduler rounds:

  * **admission** — the library's windowed Algorithm-5 planner (the
    CUDA semaphore kernel on a card) is replanned every round over the
    in-flight holds plus the queued front; a queued request is admitted
    iff the timeline grants it with ``waited == 0`` *now*. The host
    ``AdmissionController`` (a live sleeping semaphore) is the occupancy
    gate and ``grant_log`` records the FIFO grant order. One-shot
    admission (the default) prefills each granted prompt, right-padded
    to a power-of-2 bucket, and inserts its cache into the slot (paged:
    pages for the whole batch granted in one ticket-mutex critical
    section). Chunked admission (``prefill_chunk_tokens``) is
    bookkeeping only: a slot, pages for the first chunk(s), a cursor;
  * **page prep** (paged) — eager growth reserved every page at
    admission; lazy growth tops up every decoding slot and every
    planned chunk in one critical section, a starved slot pauses for
    the round, and if nobody can advance the youngest grant is preempted
    back to the queue (greedy decoding regenerates its stream);
  * **dispatch** — ``decode_chunk`` decode steps over the rows
    (paged: gathered into a power-of-2 bucket when bucketed dispatch is
    on), *then*, chunked, a ``C``-token prefill chunk for the
    FIFO-oldest prefilling rows (bucketed: over a second gather of those
    rows alone, padded to their own power-of-2 bucket, so the rows that
    only decode cost the chunk nothing). The order matters: a prefilling
    row's frozen decode steps write scratch K/V where the chunk writes,
    so the chunk must land after them;
  * **retirement** — every finished row leaves its slot (paged: every
    row's pages return in one ``free_batch``; with the prefix cache on,
    its full written pages are donated to the cache first).

**Prefix sharing** (paged; ``prefix_sharing="auto"`` turns it on there,
as the reference does): admission looks each granted prompt up in the
live ``PrefixIndex`` and, when on, the retained ``PrefixCache``, and
adopts the matched pages by an incref riding the admission grant's
critical section; a prefix hit never jumps the FIFO. A slot about to
write a shared page gets a private copy in the round's page-prep section
(the CoW split, with the keeper rule), or pauses. Refcounts, tables and
split plans are host state: the split adds one index upload a round
that splits, and no device read.

**The request lifecycle** (as the reference's): ``cancel`` tears a
request down in any state — at once in the queue, at the next round
boundary once granted (its pages ride the round's retirement section,
a cancelled chunked prefill donating its written pages to the prefix
cache). Deadlines (``submit(deadline_step=, deadline_s=)``) expire a
queued request before admission; a granted one turns *late*: its chunks
go behind every on-time row and it is the first preemption victim, which
expires it rather than requeueing it. A seeded ``FaultPlan`` injects
allocator aborts (the batch rolls back; an aborted admission requeues
its requests, an aborted page prep pauses the round), stuck allocator
holders (``allocator_watchdog_s`` arms the mutex watchdog) and dispatch
failures; a failed round is retried with backoff and the request blamed
``quarantine_after`` times in a row ends ``FAILED``. A round's dispatch
changes no host state before it returns — the arena writes it may have
made land at positions at or past each row's length, and the replay
rewrites them with the same values — so a retried round is the round
that failed. One deliberate difference from the reference, which retries
any exception of the dispatch: an error of the kernel layer
(``kernels.build.KernelError``: a build, a launch or a device error
word) or of the CUDA runtime leaves ``step`` at once, unretried, with
nothing quarantined, so no fault of the card is absorbed as a round
failure.

**Sampling** (``temperature > 0``) draws from ``softmax(logits / T)``
through an explicit ``torch.Generator`` on the engine's device (Philox
on a card) seeded from ``seed``, in the reference's draw order: one draw
per one-shot prefill, one per decode step of a round (every row of the
batch), one per chunked completion. A failed dispatch restores the
generator's state from before it, so the retried round replays the same
draws. Sampling takes the gates of a model with a mamba layer, as in the
reference: eager page growth, no chunked prefill, no prefix sharing or
cache under ``auto``, full-batch dispatch.

**Recurrent models** (a ``mamba`` layer: falcon-mamba, jamba) prefill
at the exact prompt length, never padded (``_can_pad``), and their state
``{conv, h}`` stays slot-dense in both layouts; decode steps it on every
row, frozen and vacant ones included, as the reference's batched decode
does, and an insert overwrites a refilled slot's row.

The reference relies on JAX's dropping scatters; the port masks lanes
out *before* each scatter instead: the ``_DROP_POS`` write sentinel and
sentinel pages (``models.attention.page_write_plan``), retired slot rows
past ``max_len`` (``models.attention.scatter_rows``) and the bucket
round's scatter-back to row ``K`` (only live bucket lanes are written
back, see ``_bucket_round``; the chunk's own gather is never scattered
back: the engine reads its logits at each chunk row's place in it).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import math
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.spans import PhaseClock, span
from repro_torch.kernels.build import is_device_error
from repro_torch.serve.dispatch import DecodeDispatchCache
from repro_torch.serve.faults import FaultPlan, InjectedFault
from repro_torch.serve.kv_pages import PagedSlotPool, PrefixIndex
from repro_torch.serve.kv_slots import SlotPool
from repro_torch.serve.prefix_cache import PrefixCache, cache_key_suffix
from repro_torch.serve.scheduler import (AdmissionController,
                                         allocator_contention, plan_round)
from repro_torch.sync import SyncLibrary

#: Write-drop sentinel for chunked prefill: pad lanes of a partial last
#: chunk and rows not advancing this round carry it as their write
#: position. Large and positive — past any block table and any slot
#: row, so the masked scatter leaves it out.
_DROP_POS = 2 ** 30


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next tokens [B] int32 from logits [B, V]: argmax at temperature
    0, else one categorical draw per row from ``softmax(logits / T)`` by
    the Gumbel-max rule (the form of the reference's
    ``jax.random.categorical``), its uniforms from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)


class RoundDispatchError(RuntimeError):
    """A scheduler round's dispatch failed on the host side. Carries the
    blamed request id when the underlying fault named one; ``step``
    retries the round with backoff and quarantines the blamed request
    after ``quarantine_after`` consecutive failures. Errors of the kernel
    layer or the CUDA runtime are never wrapped in it."""

    def __init__(self, cause: BaseException, rid: Optional[int] = None):
        self.rid = rid
        super().__init__(f"round dispatch failed: {cause!r}")


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # [B, n_generated]
    logprobs: Optional[torch.Tensor] = None


class ServeEngine:
    """Legacy engine: one whole-prompt prefill, then a per-step Python
    decode loop over the batch (no slot reuse, no admission). Greedy at
    temperature 0, else sampled; runs on the device ``params`` live
    on. The only engine that serves an encoder-decoder model: its
    prefill encodes ``batch["embeds"]`` and decodes BOS, its self cache
    sized by the config's ``decoder_len``, as the reference's."""

    def __init__(self, model, params, *, max_len: int = 256,
                 temperature: float = 0.0):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.temperature = temperature

    def prefill(self, batch: Dict[str, torch.Tensor]):
        if self.model.cfg.is_encdec:
            return self.model.prefill(self.params, batch)
        return self.model.prefill(self.params, batch, max_len=self.max_len)

    def generate(self, batch: Dict[str, torch.Tensor], n_tokens: int,
                 eos_id: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """``n_tokens`` tokens per row of the batch (``tokens``, or the
        encoder-decoder's ``embeds``): one draw from ``generator``
        (default seeded 0 on the device of the batch's tensors) for the
        prefill's token and one per decode step; with ``eos_id`` a row
        that emitted it keeps emitting it, and the loop stops early once
        every row has."""
        T = self.temperature
        if generator is None and T > 0.0:
            generator = torch.Generator(
                device=next(iter(batch.values())).device).manual_seed(0)
        logits, cache = self.prefill(batch)
        tok = _sample(logits, T, generator)
        outs = [tok]
        done = torch.zeros_like(tok, dtype=torch.bool)
        for _ in range(n_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = _sample(logits, T, generator)
            if eos_id is not None:
                done = done | (tok == eos_id)
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            outs.append(tok)
            if eos_id is not None and bool(done.all()):
                break
        return GenerationResult(tokens=torch.stack(outs, dim=1))


class RequestState(str, enum.Enum):
    """QUEUED → PREFILLING → DECODING → FINISHED is the happy path;
    CANCELLED (torn down by the client), EXPIRED (past its deadline in
    the queue, or evicted while late) and FAILED (quarantined after
    repeated round failures) are the other terminal states. A
    lazy-growth preemption moves an on-time request back to QUEUED
    (restart, not termination)."""
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL_STATES


_TERMINAL_STATES = frozenset({RequestState.FINISHED,
                              RequestState.CANCELLED,
                              RequestState.EXPIRED,
                              RequestState.FAILED})


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
    #: absolute deadlines on the step clock and on ``time.perf_counter``
    #: (None: no SLO); past either, a queued request expires and an
    #: active one is late
    deadline_step: Optional[int] = None
    deadline_s: Optional[float] = None
    decode_start_step: int = -1
    preemptions: int = 0
    prefill_chunks: int = 0
    #: why the request FAILED (None in every other state)
    error: Optional[str] = None
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

    def past_deadline(self, step_clock: int,
                      now_s: Optional[float] = None) -> bool:
        """Whether either deadline has passed (a request AT its deadline
        step is still on time)."""
        if self.deadline_step is not None and step_clock > self.deadline_step:
            return True
        if self.deadline_s is not None:
            if (now_s if now_s is not None
                    else time.perf_counter()) > self.deadline_s:
                return True
        return False


class SlotServeEngine:
    """Continuous-batching engine over a fixed KV slot arena.

    Drive it with ``submit`` + ``run_until_done``, or ``step`` from an
    outer loop. Runs on ``device`` (default ``cuda``; raises without a
    card unless ``device="cpu"``); ``params`` must live there.
    ``kv_layout`` is ``"slots"`` (contiguous, the default) or
    ``"paged"``; ``prefill_chunk_tokens`` unset means one-shot prefill.
    On the paged layout ``page_growth`` is ``"lazy"`` or ``"eager"``,
    ``attention_impl="fused"`` decodes through the fused paged-decode
    kernel (``"gather"`` through gather-then-attend), and bucketed
    dispatch (``"auto"``) is on. ``prefix_sharing`` ("auto": on for the
    paged layout) and ``prefix_cache`` ("off" by default; "auto": on for
    the paged layout) resolve as the reference's. A model with a mamba
    layer, or ``temperature > 0`` (sampled from a generator seeded with
    ``seed``), resolves as the reference does too: eager growth, no
    chunked prefill, sharing and the cache off under ``auto``, no
    bucketed dispatch (``"on"`` raises); ``cache_watermark`` is
    the free-page share the cache's eviction defends (default the
    admission headroom). ``fault_plan`` installs seeded fault injection;
    ``quarantine_after`` consecutive failed rounds blamed on one request
    fail it, ``retry_backoff_s`` spaces the retries, and
    ``allocator_watchdog_s`` arms the page allocator's holder watchdog.
    """

    def __init__(self, model, params, *, capacity: int, max_len: int,
                 temperature: float = 0.0, decode_chunk: int = 1,
                 eos_id: Optional[int] = None, seed: int = 0,
                 pad_prompts_to: Optional[int] = None,
                 use_admission_kernel: bool = True,
                 plan_window: int = 64,
                 kv_layout: str = "slots",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 page_growth: str = "lazy",
                 admit_headroom: float = 0.1,
                 page_lookahead_chunks: int = 2,
                 allocator_wait: Optional[str] = None,
                 prefix_sharing: str = "auto",
                 prefix_cache: str = "off",
                 cache_watermark: Optional[float] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 round_token_budget: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 quarantine_after: int = 3,
                 retry_backoff_s: float = 0.001,
                 allocator_watchdog_s: Optional[float] = None,
                 attention_impl: str = "gather",
                 bucketed_dispatch: str = "auto",
                 sync: Optional[SyncLibrary] = None,
                 device=None):
        cfg = model.cfg
        if cfg.is_encdec or cfg.frontend is not None:
            raise ValueError("SlotServeEngine drives decoder-only token LMs")
        if capacity < 1 or decode_chunk < 1:
            raise ValueError("capacity and decode_chunk must be >= 1")
        if kv_layout not in ("slots", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if page_growth not in ("eager", "lazy"):
            raise ValueError(f"unknown page_growth {page_growth!r}")
        if attention_impl not in ("gather", "fused"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}; "
                             f"expected gather or fused")
        if attention_impl == "fused" and kv_layout != "paged":
            raise ValueError("attention_impl='fused' requires "
                             "kv_layout='paged' (the fused kernel walks "
                             "a block table)")
        if bucketed_dispatch not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown bucketed_dispatch {bucketed_dispatch!r}; "
                f"expected auto, on, or off")
        if prefix_sharing not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown prefix_sharing {prefix_sharing!r}; "
                f"expected auto, on, or off")
        if prefix_sharing == "on" and kv_layout != "paged":
            raise ValueError("prefix_sharing requires kv_layout='paged' "
                             "(the contiguous arena has no pages to share)")
        if prefix_cache not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown prefix_cache {prefix_cache!r}; "
                f"expected auto, on, or off")
        if prefix_cache == "on" and kv_layout != "paged":
            raise ValueError("prefix_cache requires kv_layout='paged' "
                             "(the contiguous arena has no pages to retain)")
        chunk = int(prefill_chunk_tokens) if prefill_chunk_tokens else 0
        if chunk < 0:
            raise ValueError("prefill_chunk_tokens must be >= 1 (or None)")
        # a mamba prefill is recurrent: right-padding would run the pad
        # through the state, so such a model prefills at exact length
        self._can_pad = "mamba" not in model.cfg.layer_pattern
        # bucketing gathers only [K]-shaped round state (sound where the
        # arena is batch-free: paged, no slot-dense mamba state) and
        # needs per-row results independent of the batch shape (a draw
        # per row of the full batch is not)
        greedy_attn = temperature <= 0.0 and self._can_pad
        bucket_ok = kv_layout == "paged" and greedy_attn
        if bucketed_dispatch == "on" and not bucket_ok:
            raise ValueError(
                "bucketed_dispatch='on' requires kv_layout='paged', "
                "greedy decoding, and attention-only layers")
        self.device = resolve_device(device)
        emb = params["embed"]["tokens"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self.params = params
        self.capacity = capacity
        self.max_len = max_len
        self.temperature = float(temperature)
        self.decode_chunk = decode_chunk
        self.eos_id = eos_id
        self.pad_prompts_to = pad_prompts_to
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        self.attention_impl = attention_impl
        self.sync = sync if sync is not None else SyncLibrary.host_default()
        # the planning trace holds all K in-flight requests plus the
        # queued front; a window below capacity would cap concurrency
        self.plan_window = max(plan_window, 2 * capacity)
        self.bucketed_dispatch = bucketed_dispatch == "on" or (
            bucketed_dispatch == "auto" and bucket_ok)
        self._dispatch_cache = (DecodeDispatchCache(capacity)
                                if self.bucketed_dispatch else None)
        # a preemption restarts its victim from the prompt: only greedy
        # attention regenerates the same stream (mamba state advances on
        # paused rows; a sampled restart would retract observed tokens)
        self.page_growth = (page_growth if self.paged and greedy_attn
                            else "eager")
        # a chunked prompt cannot resume a recurrent state, and its
        # first token would be drawn in another order than one-shot's
        if not greedy_attn:
            chunk = 0
        self.prefill_chunk = chunk
        self.round_token_budget = (
            int(round_token_budget) if round_token_budget
            else capacity * (decode_chunk + chunk))
        # "auto" turns sharing and the cache on where their streams stay
        # comparable on and off: paged, greedy, attention prefill
        self.prefix_sharing = prefix_sharing == "on" or (
            prefix_sharing == "auto" and self.paged and greedy_attn)
        cache_on = prefix_cache == "on" or (
            prefix_cache == "auto" and self.paged and greedy_attn)
        self.cache_watermark = (float(cache_watermark)
                                if cache_watermark is not None
                                else float(admit_headroom))
        self.admit_headroom = float(admit_headroom)
        self.page_lookahead_chunks = max(int(page_lookahead_chunks), 1)
        if self.paged:
            self.pool = PagedSlotPool(
                model, capacity, max_len, page_size=page_size,
                num_pages=num_pages, max_pages_per_slot=max_pages_per_slot,
                sync=self.sync, wait_mode=allocator_wait,
                expected_contention=allocator_contention(
                    capacity, service_steps=float(max_len)),
                watchdog_s=allocator_watchdog_s, device=self.device)
        else:
            self.pool = SlotPool(model, capacity, max_len, self.device)
        # fault tolerance: dormant (no extra acquire, no extra state
        # transition) unless a plan is installed or a round fails
        self.fault_plan = fault_plan
        self.quarantine_after = max(int(quarantine_after), 1)
        self.retry_backoff_s = float(retry_backoff_s)
        self.rounds_retried = 0
        self.requests_quarantined = 0
        #: rid -> consecutive round failures blamed on it; cleared by any
        #: successful dispatch
        self._round_failures: Dict[int, int] = {}
        if self.paged and fault_plan is not None:
            self.pool.pages.fault_hook = fault_plan.alloc_hook
        self.admission = AdmissionController(capacity, lib=self.sync)
        self._admission_planner = (
            self.sync.semaphore_planner(capacity, window=self.plan_window,
                                        device=self.device)
            if use_admission_kernel else None)
        self.prefix_index = (PrefixIndex(self.pool.page_size,
                                         self.pool.pages)
                             if self.prefix_sharing else None)
        self.prefix_cache = (PrefixCache(self.pool.page_size,
                                         self.pool.pages)
                             if cache_on else None)
        if self.prefix_cache is not None:
            # the trie's references live outside the block tables
            self.pool.register_external_holder(self.prefix_cache.holders)
        self.queue: Deque[ServeRequest] = collections.deque()
        self.active: Dict[int, ServeRequest] = {}      # slot -> request
        self.finished: List[ServeRequest] = []
        self.grant_log: List[int] = []                 # rids in grant order
        self.step_clock = 0
        self.decode_dispatches = 0
        self.decode_steps_run = 0   # model decode steps (each: every layer)
        self.pauses = 0
        self.preemptions = 0
        self.prefix_hits = 0     # admissions that adopted a prefix
        self.shared_pages_adopted = 0   # pages incref'd instead of granted
        self.cache_hits = 0      # admissions that adopted a cached prefix
        self.cache_tokens_served = 0    # flat positions served from cache
        self.prefill_tokens_saved = 0   # chunked prompt tokens skipped
        self.cow_splits = 0      # private copies made on divergent writes
        self.prefill_tokens = 0
        self.pad_tokens = 0
        self.prefill_chunks = 0
        #: rows of the chunk call x chunk tokens over the rounds that ran
        #: a prefill chunk (bucketed: the chunk rows' own bucket, else
        #: every slot; each row's lanes are all computed)
        self.prefill_lanes_computed = 0
        #: the round's phases on the host clock (they tile ``step``) and
        #: the dispatch's device spans, read after the token copy
        self._clock = PhaseClock(
            self.device, ("prep", "dispatch", "fetch", "post"),
            {"decode": ("decode", "decode_end"),
             "prefill": ("decode_end", "prefill_end"),
             "dispatch": ("dispatch", "dispatch_end")}, prefix="serve.")
        #: one-shot rounds whose admissions prefilled while a request
        #: was decoding (the stall chunked prefill removes)
        self.decode_rounds_stalled_by_prefill = 0
        self.cancellations = 0   # requests torn down by cancel()
        self.expiries = 0        # requests shed or evicted past a deadline
        #: active rids whose cancellation waits for the next round boundary
        self._cancel_pending: Set[int] = set()
        self._next_rid = 0
        self._last_tok = np.zeros(capacity, np.int32)
        self._steps_left = np.zeros(capacity, np.int64)
        # chunked-prefill cursor per slot: prefilling while pos < end
        self._pf_pos = np.zeros(capacity, np.int64)
        self._pf_end = np.zeros(capacity, np.int64)
        # lazy top-up cap: the flat positions the request can touch
        self._grow_cap = np.zeros(capacity, np.int64)
        # full pages of each decoding slot's prompt + reply registered in
        # the live index (generated-boundary registration, cache on)
        self._gen_reg = np.zeros(capacity, np.int64)
        #: page groups whose references must drop in the round's next
        #: allocator section (cancelled and quarantined requests' pages,
        #: cache evictions planned for an admission that staged nobody)
        self._deferred_free: List[np.ndarray] = []
        #: the sampling stream (Philox on a card); greedy draws nothing
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next tokens [B] from logits [B, V] at the engine's temperature,
        drawing from its generator."""
        return _sample(logits, self.temperature, self._gen)

    # ------------------------------------------------------------ submission
    def submit(self, prompt, max_new_tokens: int, rid: Optional[int] = None,
               deadline_step: Optional[int] = None,
               deadline_s: Optional[float] = None) -> ServeRequest:
        """Queue a request. ``deadline_step`` / ``deadline_s`` are
        absolute (step clock / ``time.perf_counter()``): past either, the
        request is shed from the queue as EXPIRED, and once granted it
        turns late — its chunks go behind on-time rows and it is the
        first page-pressure eviction victim, which expires it."""
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
                           arrival_s=time.perf_counter(),
                           deadline_step=deadline_step,
                           deadline_s=deadline_s)
        self.queue.append(req)
        return req

    def _terminate(self, req: ServeRequest, state: RequestState,
                   now_s: Optional[float] = None) -> None:
        """Move ``req`` into a terminal state other than FINISHED, at the
        current step."""
        req.state = state
        req.finish_step = self.step_clock
        req.finish_s = time.perf_counter() if now_s is None else now_s
        self.finished.append(req)

    def _vacate(self, slot: int) -> Optional[np.ndarray]:
        """Clear ``slot``'s cursors and counters, evict it and release its
        grant; returns its pages (paged), which the caller frees or
        defers."""
        self._steps_left[slot] = 0
        self._grow_cap[slot] = 0
        self._pf_pos[slot] = 0
        self._pf_end[slot] = 0
        self._gen_reg[slot] = 0
        held = (self.pool.evict(slot, free_pages=False) if self.paged
                else self.pool.evict(slot))
        self.admission.release_slot()
        return held if self.paged else None

    # ---------------------------------------------------------- cancellation
    def cancel(self, rid: int) -> bool:
        """Request cancellation of ``rid``; True when it was still live
        (queued or active). A queued request is torn down at once (it
        holds no slot and no page). An active one is retired at the next
        round boundary: its slot and semaphore grant free before that
        round's admission, and its pages (shared ones decref) ride the
        round's retirement section — no extra allocator acquire."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._terminate(req, RequestState.CANCELLED)
                self.cancellations += 1
                return True
        for req in self.active.values():
            if req.rid == rid:
                self._cancel_pending.add(rid)
                return True
        return rid in self._cancel_pending

    def _apply_cancels(self) -> int:
        """Round-boundary cancellation: retire every marked active slot,
        deferring its pages to the round's retirement section. A request
        torn down mid-prefill donates its written full pages to the
        prefix cache up to its cursor."""
        if not self._cancel_pending:
            return 0
        rids, self._cancel_pending = self._cancel_pending, set()
        slots = [s for s, r in self.active.items() if r.rid in rids]
        for slot in slots:
            req = self.active.pop(slot)
            self._terminate(req, RequestState.CANCELLED)
            # the written extent, read before the cursors reset
            pf_pos = (int(self._pf_pos[slot])
                      if self._prefilling(slot) else None)
            held = self._donate_on_retire(req, self._vacate(slot),
                                          prefill_pos=pf_pos)
            if held is not None and held.size:
                self._deferred_free.append(held)
            self.cancellations += 1
        return len(slots)

    # -------------------------------------------------------------- deadlines
    def _expire_queued(self) -> int:
        """Shed queued requests already past their deadline, before the
        admission plan (which then never plans an expired request)."""
        if not any(r.deadline_step is not None or r.deadline_s is not None
                   for r in self.queue):
            return 0
        now_s = time.perf_counter()
        keep: Deque[ServeRequest] = collections.deque()
        n = 0
        for req in self.queue:
            if req.past_deadline(self.step_clock, now_s):
                self._terminate(req, RequestState.EXPIRED, now_s)
                self.expiries += 1
                n += 1
            else:
                keep.append(req)
        self.queue = keep
        return n

    def _late(self, slot: int) -> bool:
        """Whether the active request in ``slot`` is past its deadline."""
        return self.active[slot].past_deadline(self.step_clock)

    # --------------------------------------------------------- fault recovery
    def _faults_off(self):
        """Suppress injection: recovery and compensation run under it, so
        a rollback can never itself be faulted into a wedge."""
        if self.fault_plan is not None:
            return self.fault_plan.suspended()
        return contextlib.nullcontext()

    def _free_batch_safe(self, groups) -> List[int]:
        """``free_batch`` that survives an injected mid-batch fault: the
        undo journal rolled the batch back, so the retry (injection
        suspended) applies it. Real allocator errors still propagate."""
        if not groups:
            return []
        try:
            return self.pool.pages.free_batch(groups)
        except InjectedFault:
            with self._faults_off():
                return self.pool.pages.free_batch(groups)

    def _quarantine(self, rid: int, exc: BaseException) -> None:
        """Evict one repeatedly blamed request into FAILED: its slot and
        grant free at once, its pages ride the deferred frees, and none is
        donated (its K/V is suspect)."""
        slot = next(s for s, r in self.active.items() if r.rid == rid)
        req = self.active.pop(slot)
        req.error = str(exc)
        self._terminate(req, RequestState.FAILED)
        held = self._vacate(slot)
        if held is not None and held.size:
            self._deferred_free.append(held)
        self.requests_quarantined += 1

    def _recover_round(self, exc: BaseException) -> None:
        """Blame one round failure — on the fault's own rid when it names
        a live request, else on the newest grant — and quarantine the
        culprit once it reaches ``quarantine_after`` in a row."""
        live = {r.rid for r in self.active.values()}
        if not live:
            return
        rid = getattr(exc, "rid", None)
        if rid is None or rid not in live:
            rid = max(live)
        self._round_failures[rid] = self._round_failures.get(rid, 0) + 1
        if self._round_failures[rid] >= self.quarantine_after:
            self._quarantine(rid, exc)
            self._round_failures.pop(rid, None)

    def _reserve_staged(self, staged, grant_at: int, shared_at: int,
                        evict_groups) -> Optional[list]:
        """The admission batch's one allocator section (``staged`` tuples
        hold the request, its slot, its grant at ``grant_at`` and its
        adopted pages at ``shared_at``). If an injected fault aborts it
        (the undo journal rolled every grant, incref and decref back),
        the batch is unstaged — slots and grants return, the requests go
        back to the queue front in arrival order, the planned cache
        evictions land with injection suspended (the trie already forgot
        them) — and None is returned."""
        try:
            return self.pool.reserve_batch(
                [(t[1], t[grant_at]) for t in staged],
                shared=[t[shared_at] for t in staged],
                evict=evict_groups or None)
        except InjectedFault:
            for t in reversed(staged):
                self.pool.evict(t[1], free_pages=False)
                self.admission.release_slot()
                self.queue.appendleft(t[0])
            with self._faults_off():
                self._free_batch_safe(evict_groups)
            self.rounds_retried += 1
            return None

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

    def _bucket_len(self, n: int) -> int:
        """The prompt's prefill length: ``pad_prompts_to`` or the next
        power of 2 from 8, never past what a slot holds; exactly ``n``
        for a model with a mamba layer."""
        if not self._can_pad:
            return n
        if self.pad_prompts_to is not None:
            b = max(self.pad_prompts_to, n)
        else:
            b = 8
            while b < n:
                b *= 2
        return min(b, self.pool.virtual_max_len)

    def _headroom_pages(self) -> int:
        return int(np.ceil(self.admit_headroom * self.pool.pages.num_pages))

    def _watermark_pages(self) -> int:
        """The free-page floor the prefix cache's eviction defends."""
        return int(np.ceil(self.cache_watermark * self.pool.pages.num_pages))

    def _prefill_impl(self, tokens: torch.Tensor,
                      length: Optional[torch.Tensor], pad_to: int):
        """One-shot prefill of a right-padded ``[1, bucket]`` prompt; the
        cache's time extent is ``pad_to`` (a whole slot row, or just the
        bucket for the paged insert)."""
        return self.model.prefill(self.params, {"tokens": tokens},
                                  max_len=pad_to, length=length)

    def _lookup_prefix(self, prompt, bucket: int, schedule: int
                       ) -> Tuple[int, Optional[np.ndarray], bool]:
        """Longest prefix match across the live index and the retained
        cache: ``(matched_tokens, page_ids, from_cache)``. Ties go to the
        cache (a live entry for a retiree's pages is valid only because
        the cache retains them; crediting the cache keeps its LRU clock
        honest); a strictly longer live match, such as a partial tail
        past the cache's page granularity, wins."""
        sh_len, sh_ids = 0, None
        if self.prefix_sharing:
            sh_len, sh_ids = self.prefix_index.lookup(prompt, bucket,
                                                      schedule=schedule)
        from_cache = False
        if self.prefix_cache is not None:
            c_len, c_ids = self.prefix_cache.lookup(
                prompt, cache_key_suffix(bucket, schedule))
            if c_ids is not None and c_len >= sh_len:
                sh_len, sh_ids, from_cache = c_len, c_ids, True
        return sh_len, sh_ids, from_cache

    def _plan_evictions(self, deficit: int) -> Tuple[List[np.ndarray], int]:
        """The cache's LRU plan for ``deficit`` reclaimable pages; the
        caller hands every group to its next allocator section (the trie
        already forgot them)."""
        if (self.prefix_cache is None or deficit <= 0
                or self.prefix_cache.pages_held <= 0):
            return [], 0
        return self.prefix_cache.evict_plan(deficit)

    def _evict_credit(self, evict_groups: List[np.ndarray],
                      adopt_groups) -> int:
        """Pages the planned evictions will really free: refcount 1 and
        not re-adopted by the same batch (recomputed at every gate)."""
        if not evict_groups:
            return 0
        adopt = {int(p) for g in adopt_groups if g is not None
                 for p in np.asarray(g).reshape(-1)}
        credit = 0
        for g in evict_groups:
            rc = self.pool.pages.refcounts(g)
            credit += sum(1 for p, r in zip(g.tolist(), rc.tolist())
                          if r == 1 and int(p) not in adopt)
        return credit

    def _gate(self, staged_pages, evict_groups, adopt_groups, n_shared,
              pick, deficit_tokens) -> Optional[int]:
        """Admission's page gate for the FIFO head: ``pick(extra_free)``
        gives the grant (tokens) that fits or None. Short on pages, the
        cache's LRU covers the deficit of ``deficit_tokens``; its
        evictions join ``evict_groups`` and ride the batch's grant."""
        credit = self._evict_credit(evict_groups, adopt_groups)
        grant = pick(credit)
        if grant is None:
            deficit = (
                max(self.pool.pages.pages_for(deficit_tokens) - n_shared, 0)
                + staged_pages + self._headroom_pages()
                - self.pool.pages.n_free - credit)
            groups, _ = self._plan_evictions(deficit)
            evict_groups.extend(groups)
            grant = pick(self._evict_credit(evict_groups, adopt_groups))
        return grant

    def _count_adoption(self, sh_ids, sh_len, from_cache,
                        skipped: bool) -> None:
        if sh_ids is None or not sh_ids.size:
            return
        self.prefix_hits += 1
        self.shared_pages_adopted += int(sh_ids.size)
        if skipped:
            # adopted chunks are never dispatched, whichever index matched
            self.prefill_tokens_saved += sh_len
        if from_cache:
            self.cache_hits += 1
            self.cache_tokens_served += sh_len

    def _admit(self) -> int:
        """One-shot admission of the FIFO front the Algorithm-5 timeline
        grants now: slots first, then (paged) every page grant of the
        batch — private pages, prefix-adoption increfs and cache
        evictions — in ONE allocator critical section, then each
        request's whole-prompt prefill into its slot and its first
        token. The prefill bucket plus a decode lookahead is granted
        under lazy growth, the worst case under eager growth. A
        page-starved FIFO head waits for retirements; later requests do
        not jump it, a prefix hit included. Requests of one batch cannot
        adopt from each other: the index warms for the next round."""
        if self.prefill_chunk:
            return self._admit_chunked()
        had_decoders = bool(self.active)
        n_admit = self._planned_admit_count()
        staged = []       # (req, slot, lp, bucket, reserve, grant, sh_ids,
        staged_pages = 0  #  sh_len, from_cache)
        evict_groups: List[np.ndarray] = []
        lazy = self.paged and self.page_growth == "lazy"
        while len(staged) < n_admit and self.queue and self.pool.n_free:
            req = self.queue[0]
            lp = int(req.prompt.size)
            bucket = self._bucket_len(lp)
            reserve = max(bucket, lp + req.max_new_tokens + 1)
            need = max(lp + req.max_new_tokens - 1, lp)
            grant = (max(bucket, min(bucket + self.decode_chunk
                                     * self.page_lookahead_chunks, need))
                     if lazy else reserve)
            sh_len, sh_ids, from_cache = self._lookup_prefix(
                req.prompt, bucket, 0)
            n_shared = 0 if sh_ids is None else int(sh_ids.size)
            if self.paged:
                def pick(extra: int) -> Optional[int]:
                    ok = (self.pool.can_admit_lazy(
                              grant, reserve,
                              headroom_pages=self._headroom_pages(),
                              pending_pages=staged_pages,
                              shared_pages=n_shared, extra_free=extra)
                          if lazy else
                          self.pool.can_reserve(
                              reserve, pending_pages=staged_pages,
                              shared_pages=n_shared, extra_free=extra))
                    return grant if ok else None
                if self._gate(staged_pages, evict_groups,
                              [t[6] for t in staged] + [sh_ids], n_shared,
                              pick, grant) is None:
                    break
            self.queue.popleft()
            # Algorithm-5 wait(): never blocks — the planner only granted
            # as many requests as there are free slots
            if not self.admission.acquire_slot(timeout=5.0):
                self.queue.appendleft(req)
                break
            slot = self.pool.acquire(req.rid)
            staged.append((req, slot, lp, bucket, reserve, grant,
                           sh_ids, sh_len, from_cache))
            if self.paged:
                staged_pages += max(
                    self.pool.pages.pages_for(grant) - n_shared, 0)
        if not staged:
            # planned evictions must still land: they ride the round's
            # retirement section
            self._deferred_free.extend(evict_groups)
            return 0
        grants = [None] * len(staged)
        if self.paged:
            grants = self._reserve_staged(staged, 5, 6, evict_groups)
            if grants is None:
                return 0
        instant = []                 # eos / no budget on the prefill token
        dev = self.device
        for (req, slot, lp, bucket, reserve, grant, sh_ids, sh_len,
             from_cache), ids in zip(staged, grants):
            padded = np.zeros(bucket, np.int32)
            padded[:lp] = req.prompt
            length = (torch.tensor([lp], dtype=torch.int32, device=dev)
                      if bucket != lp else None)
            logits, cache = self._prefill_impl(
                torch.from_numpy(padded)[None].to(dev), length,
                pad_to=bucket if self.paged else self.max_len)
            self.prefill_tokens += lp
            self.pad_tokens += bucket - lp
            tok0 = int(self._sample(logits)[0])
            if self.paged:
                self.pool.insert(slot, cache, lp, reserve=grant, ids=ids,
                                 shared_ids=sh_ids, shared_len=sh_len)
                self._count_adoption(sh_ids, sh_len, from_cache, False)
                if self.prefix_sharing:
                    self.prefix_index.register(
                        req.prompt, bucket,
                        self.pool.page_ids(slot,
                                           self.pool.pages.pages_for(lp)))
                self._gen_reg[slot] = lp // self.pool.page_size
            else:
                self.pool.insert(slot, cache, lp, reserve=reserve)
            self._last_tok[slot] = tok0
            self._steps_left[slot] = req.max_new_tokens - 1
            self._grow_cap[slot] = max(lp + req.max_new_tokens - 1, lp)
            req.slot = slot
            if req.preemptions == 0 or req.grant_step < 0:
                # a preempted request keeps its first grant's log entry
                req.grant_step = self.step_clock
                req.grant_s = time.perf_counter()
                self.grant_log.append(req.rid)
            # prefilled inside the granting round: PREFILLING is
            # instantaneous on the step clock
            req.state = RequestState.DECODING
            req.decode_start_step = self.step_clock
            req.out_tokens.append(tok0)
            if self.eos_id is not None and tok0 == self.eos_id:
                req.eos = True
            self.active[slot] = req
            if req.eos or self._steps_left[slot] <= 0:
                instant.append((slot, 0))
        self._retire_batch(instant)
        if had_decoders:
            self.decode_rounds_stalled_by_prefill += 1
        return len(staged)

    def _admit_chunked(self) -> int:
        """Chunked admission: pure bookkeeping, no model dispatch. Paged
        page grants are tiered under lazy growth — the whole prompt plus
        the decode lookahead when pages allow, else a chunk-lookahead
        window, else the first chunk — or the worst case under eager
        growth, and one allocator critical section covers the batch.
        The slot layout needs no pages.

        An adopted prefix is keyed ``schedule=C`` and trimmed to a
        multiple of lcm(page_size, C), so adoption skips whole chunks
        and every resumed chunk stays canonically aligned; the last
        chunk stays private (the first token's logits come from a chunk
        this engine runs)."""
        n_admit = self._planned_admit_count()
        staged = []       # (req, slot, lp, grant, sh_ids, sh_len, from_cache)
        staged_pages = 0
        evict_groups: List[np.ndarray] = []
        C = self.prefill_chunk
        look = self.page_lookahead_chunks
        lazy = self.paged and self.page_growth == "lazy"
        while len(staged) < n_admit and self.queue and self.pool.n_free:
            req = self.queue[0]
            lp = int(req.prompt.size)
            need = max(lp + req.max_new_tokens - 1, lp)
            reserve = lp + req.max_new_tokens + 1
            sh_len, sh_ids, from_cache = self._lookup_prefix(req.prompt, 0,
                                                             C)
            if sh_ids is not None:
                ps = self.pool.page_size
                align = ps * C // math.gcd(ps, C)
                keep = (min(sh_len, lp - 1) // align) * align
                if keep // ps <= 0:
                    sh_len, sh_ids, from_cache = 0, None, False
                else:
                    sh_ids, sh_len = sh_ids[:keep // ps], keep
            n_shared = 0 if sh_ids is None else int(sh_ids.size)
            grant = 0
            if self.paged:
                first = min(sh_len + C, need)
                window = min(sh_len + C * look, need)
                generous = min(max(lp, first) + self.decode_chunk * look,
                               need)

                def pick(extra: int) -> Optional[int]:
                    if lazy:
                        return next(
                            (g for g in (generous, window, first)
                             if self.pool.can_admit_lazy(
                                 g, reserve,
                                 headroom_pages=self._headroom_pages(),
                                 pending_pages=staged_pages,
                                 shared_pages=n_shared, extra_free=extra)),
                            None)
                    return (reserve if self.pool.can_reserve(
                        reserve, pending_pages=staged_pages,
                        shared_pages=n_shared, extra_free=extra) else None)
                grant = self._gate(staged_pages, evict_groups,
                                   [t[4] for t in staged] + [sh_ids],
                                   n_shared, pick,
                                   first if lazy else reserve)
                if grant is None:
                    break
            self.queue.popleft()
            if not self.admission.acquire_slot(timeout=5.0):
                self.queue.appendleft(req)
                break
            slot = self.pool.acquire(req.rid)
            staged.append((req, slot, lp, grant, sh_ids, sh_len, from_cache))
            if self.paged:
                staged_pages += max(
                    self.pool.pages.pages_for(grant) - n_shared, 0)
        if not staged:
            self._deferred_free.extend(evict_groups)
            return 0
        grants = [None] * len(staged)
        if self.paged:
            grants = self._reserve_staged(staged, 3, 4, evict_groups)
            if grants is None:
                return 0
        for (req, slot, lp, _, sh_ids, sh_len, from_cache), ids in zip(
                staged, grants):
            if self.paged:
                self.pool.assign(slot, ids=ids, shared_ids=sh_ids,
                                 length=sh_len)
                self._count_adoption(sh_ids, sh_len, from_cache, True)
                self._gen_reg[slot] = lp // self.pool.page_size
            else:
                self.pool.assign(slot, length=sh_len)
            self._pf_pos[slot] = sh_len        # adoption = skipped chunks
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

    def _donate_on_retire(self, req: ServeRequest, held: np.ndarray,
                          prefill_pos: Optional[int] = None
                          ) -> Optional[np.ndarray]:
        """Offer a retiring request's written full pages to the prefix
        cache; return the pages still to free (the cache inherits the
        retiree's reference for those it keeps, so leaving them out of
        the free group is the donation: no extra acquire). The written
        extent is the prompt plus every written reply token (the last
        sampled token is never written), or, for a request torn down
        mid-prefill, its cursor ``prefill_pos``."""
        if self.prefix_cache is None or held is None or not held.size:
            return held
        lp = int(req.prompt.size)
        if prefill_pos is not None:
            tokens, gen_from = req.prompt[:int(prefill_pos)], None
        else:
            out = req.out_tokens
            tokens = (np.concatenate([req.prompt,
                                      np.asarray(out[:-1], np.int32)])
                      if out else req.prompt)
            gen_from = lp if tokens.size > lp else None
        if tokens.size < self.pool.page_size:
            return held
        # donor pages live under the donor's dispatch-shape root
        suffix = (cache_key_suffix(0, self.prefill_chunk)
                  if self.prefill_chunk
                  else cache_key_suffix(self._bucket_len(lp), 0))
        kept, _ = self.prefix_cache.donate(tokens, held, suffix,
                                           generated_from=gen_from)
        if kept.size:
            held = held[~np.isin(held, kept)]
        return held

    def _retire_batch(self, pairs: List[Tuple[int, int]]) -> None:
        """Retire ``(slot, step_offset)`` pairs; under the paged layout
        every retirement's pages (less what the prefix cache keeps) and
        any deferred cache evictions return in ONE allocator critical
        section."""
        deferred = []
        for slot, offset in pairs:
            req = self.active.pop(slot)
            req.state = RequestState.FINISHED
            req.finish_step = self.step_clock + offset
            req.finish_s = time.perf_counter()
            self._steps_left[slot] = 0
            if self.paged:
                held = self._donate_on_retire(
                    req, self.pool.evict(slot, free_pages=False))
                if held is not None and held.size:
                    deferred.append(held)
            else:
                self.pool.evict(slot)
            self.admission.release_slot()
            self.finished.append(req)
        deferred = self._deferred_free + deferred
        self._deferred_free = []
        if deferred:
            self._free_batch_safe(deferred)

    def _flush_deferred_frees(self) -> None:
        """Land deferred frees when a round ends before its retirement
        section."""
        if self._deferred_free:
            self._free_batch_safe(self._deferred_free)
            self._deferred_free = []

    # --------------------------------------------- lazy page growth (paged)
    def _preempt(self, slot: int) -> None:
        """Lazy-overflow eviction: the victim's pages return now. An
        on-time victim goes back to the queue front, to restart from its
        prompt (greedy decoding regenerates the same stream; its first
        grant keeps the FIFO log entry); a late one expires instead."""
        req = self.active.pop(slot)
        held = self._vacate(slot)
        if held is not None and held.size:
            self._free_batch_safe([held])
        req.slot = -1
        if req.past_deadline(self.step_clock):
            self._terminate(req, RequestState.EXPIRED)
            self.expiries += 1
            return
        req.state = RequestState.QUEUED
        req.eos = False
        req.out_tokens = []
        req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(req)

    def _prefilling(self, slot: int) -> bool:
        return self._pf_pos[slot] < self._pf_end[slot]

    def _split_plan(self, order: List[int], lens: np.ndarray,
                    steps: int) -> List[Tuple[int, int]]:
        """The round's CoW splits: every ``(slot, table_idx)`` whose
        coming writes (flat positions ``[len, len + steps)``) hit a
        shared page — except one keeper per page when every holder is
        about to write it: the longest context (ties to the oldest
        grant) keeps the page in place, since its writes start past
        everyone else's readable prefix and the others' decrefs land in
        the same section as their copies' grants."""
        targets: Dict[int, List[Tuple[int, int]]] = {}
        for s in order:
            for j, page in self.pool.shared_write_targets(
                    s, int(lens[s]), int(lens[s]) + steps):
                targets.setdefault(page, []).append((s, j))
        plan: List[Tuple[int, int]] = []
        for page, writers in targets.items():
            if int(self.pool.pages.refcounts([page])[0]) == len(writers):
                keeper = max(writers,
                             key=lambda sj: (int(lens[sj[0]]),
                                             -self.active[sj[0]].rid))
                writers = [w for w in writers if w != keeper]
            plan.extend(writers)
        return plan

    def _grow_for_chunk(self, steps: int, chunk_rows: Tuple[int, ...] = ()
                        ) -> Tuple[set, set]:
        """The per-round page prep: ONE allocator critical section tops
        up every decoding slot (to the pages this round's writes and
        reads need, a lookahead window ahead, capped at its worst case)
        and every planned prefill chunk, makes the CoW splits, and drops
        the prefix cache's watermark evictions. A decoding slot that
        cannot be covered, or whose split starved, pauses for the round;
        a chunk whose pages starve is deferred whole. If nobody can
        advance, the youngest grant is preempted until someone can.
        Prefilling rows never split: their writes start past any
        adopted prefix and their pages are registered at completion.
        Returns ``(paused_decode_slots, advancing_chunk_slots)``. Eager
        growth reserved every page at admission: without sharing there
        is nothing to do."""
        lazy = self.page_growth == "lazy"
        chunk_set = set(chunk_rows)
        if not self.active or (not lazy and not self.prefix_sharing):
            return set(), chunk_set
        C = max(self.prefill_chunk, 1)
        ps = self.pool.page_size
        lens = self.pool.lens_numpy()
        order = sorted(self.active, key=lambda s: self.active[s].rid)
        while order:
            decode_live = [s for s in order if not self._prefilling(s)]
            chunk_live = [s for s in order if s in chunk_set]
            tight = self.pool.pages.n_free <= self._headroom_pages()
            look = 1 if tight else self.page_lookahead_chunks
            items = []
            for s in (order if lazy else ()):
                if self._prefilling(s):
                    if s not in chunk_set:
                        continue      # deferred rows need no pages
                    target = min(int(self._pf_pos[s]) + C * look,
                                 int(self._pf_end[s]))
                else:
                    target = int(min(lens[s] + steps * look,
                                     self._grow_cap[s]))
                items.append((s, target))
            splits = (self._split_plan(decode_live, lens, steps)
                      if self.prefix_sharing else [])
            evict_groups: List[np.ndarray] = []
            if self.prefix_cache is not None and (items or splits):
                needed = sum(
                    max(self.pool.pages.pages_for(t)
                        - self.pool.held_pages(s), 0)
                    for s, t in items) + len(splits)
                if needed > 0:
                    evict_groups, _ = self._plan_evictions(
                        needed + self._watermark_pages()
                        - self.pool.pages.n_free)
            try:
                _, split_ok = self.pool.prepare_batch(
                    items, splits, evict_groups=evict_groups)
            except InjectedFault:
                # the undo journal rolled every grant back: land the
                # planned evictions, pause every decoding row this round
                # (their lengths roll back after the dispatch) and retry
                # the top-ups next round
                with self._faults_off():
                    self._free_batch_safe(evict_groups)
                self.rounds_retried += 1
                self.pauses += len(decode_live)
                return set(decode_live), set()
            self.cow_splits += sum(split_ok)
            paused = {s for s in decode_live
                      if self.pool.held_pages(s) * ps
                      < min(lens[s] + steps, self._grow_cap[s])}
            paused |= {s for (s, _), ok in zip(splits, split_ok) if not ok}
            starved = {s for s in chunk_live
                       if self.pool.held_pages(s) * ps
                       < min(int(self._pf_pos[s]) + C, int(self._pf_end[s]))}
            if not decode_live and not chunk_live:
                return paused, set()
            if len(paused) < len(decode_live) or len(starved) < len(
                    chunk_live):
                self.pauses += len(paused)
                return paused, chunk_set - starved
            # late rows first (evicting one expires it), else the
            # youngest grant
            victim = max(order,
                         key=lambda s: (self._late(s), self.active[s].rid))
            self._preempt(victim)
            order.remove(victim)
            chunk_set.discard(victim)
            lens = self.pool.lens_numpy()
        return set(), set()

    # ------------------------------------------------------------- dispatch
    def _decode_scan(self, cache, last_tok, frozen, steps):
        """``steps`` batched decode steps, one draw over every row per
        step when sampling. Frozen rows keep their last token (their
        cache writes are scratch); eos freezes a row for the rest of the
        chunk."""
        tok, toks = last_tok, []
        for _ in range(steps):
            logits, cache = self.model.decode_step(
                self.params, cache, tok, attn_impl=self.attention_impl)
            nxt = self._sample(logits)
            nxt = torch.where(frozen, tok, nxt)
            if self.eos_id is not None:
                frozen = frozen | (nxt == self.eos_id)
            tok = nxt
            toks.append(nxt)
        return cache, tok, torch.stack(toks)               # [steps, B]

    def _round(self, cache, last_tok, frozen, pf, steps, pf_rows=None):
        """The decode scan FIRST, then the prefill chunk when ``pf`` =
        ``(tokens, positions, write positions)`` is given — the chunk's
        writes must overwrite the scratch K/V that the frozen prefilling
        rows' decode steps wrote at their cursor. The chunk runs over the
        scan's rows, or, when ``pf_rows`` gives its own row leaves
        (``len``, ``pages``: the bucket round's chunk gather), over
        those rows of the same arena."""
        clock = self._clock
        clock.mark("decode")
        cache, tok, toks = self._decode_scan(cache, last_tok, frozen, steps)
        clock.mark("decode_end")
        pf_logits = None
        if pf is not None:
            pf_cache = cache if pf_rows is None else {**cache, **pf_rows}
            pf_logits, _ = self.model.prefill_chunk(self.params, pf_cache,
                                                    *pf)
            clock.mark("prefill_end")
        return cache, tok, toks, pf_logits

    def _bucket_round(self, cache, rows: np.ndarray, last_tok, frozen, pf,
                      steps, pf_slots: Optional[np.ndarray] = None):
        """The round over a ``[kb]``-row gather of the active slots, its
        prefill chunk over a second gather of the chunk rows alone
        (``pf_slots``, ``[kc]``, padded to their own bucket; ``pf`` is
        built at that shape). Pad lanes (row id == K) are inert: length
        0, sentinel table row, frozen, ``_DROP_POS`` writes — and only
        the live decode lanes are scattered back (the reference drops
        the pad lanes' scatter-back at the out-of-range row ``K``). The
        chunk's logits stay at the chunk gather's shape."""
        K = self.capacity
        live = np.flatnonzero(rows < K)
        dev = self.device
        sentinel = self.pool.pages.num_pages
        pf_rows = None
        with span("serve.bucket"):
            r = torch.from_numpy(
                np.minimum(rows, K - 1).astype(np.int64)).to(dev)
            pad = torch.from_numpy(rows >= K).to(dev)
            cache_b = dict(cache)
            cache_b["len"] = torch.where(pad, 0, cache["len"][r])
            cache_b["pages"] = torch.where(
                pad[:, None], sentinel, cache["pages"][r])
            if pf is not None:
                rc = torch.from_numpy(
                    np.minimum(pf_slots, K - 1).astype(np.int64)).to(dev)
                pad_c = torch.from_numpy(pf_slots >= K).to(dev)
                pf_rows = {"len": torch.where(pad_c, 0, cache["len"][rc]),
                           "pages": torch.where(pad_c[:, None], sentinel,
                                                cache["pages"][rc])}
            last_b = torch.where(pad, 0, last_tok[r])
            frozen_b = frozen[r] | pad
        cache_o, tok_b, toks_b, pf_logits = self._round(
            cache_b, last_b, frozen_b, pf, steps, pf_rows)
        with span("serve.bucket"):
            self._dispatch_cache.record_shape(
                ("round", len(rows), steps,
                 0 if pf is None else pf[0].shape[1])
                if self.prefill_chunk else ("decode", len(rows), steps))
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
        return out, tok, toks, pf_logits

    def _dispatch(self, view, frozen: np.ndarray, chunk_rows: List[int],
                  steps: int):
        """The round's device work: ``steps`` decode steps over the rows
        (bucketed when on), then the prefill chunk of ``chunk_rows`` —
        bucketed, over a gather of those rows alone, padded to their own
        bucket; off, over every slot. Returns ``(cache, tok, toks,
        pf_logits, valid)``, where ``valid`` maps each chunk row to its
        row in ``pf_logits`` and its real lane count. It changes no host
        state, so a failed dispatch can be replayed as it stood."""
        C = self.prefill_chunk
        dev = self.device
        self._clock.start_marks()
        self._clock.mark("dispatch")
        pf = None
        pf_slots = None
        valid: Dict[int, Tuple[int, int]] = {}
        if chunk_rows:
            if self.bucketed_dispatch:
                pf_slots = self._dispatch_cache.pad_rows(
                    chunk_rows, self._dispatch_cache.bucket(len(chunk_rows)))
                at = {s: i for i, s in enumerate(chunk_rows)}
            else:
                at = {s: s for s in chunk_rows}
            n = self.capacity if pf_slots is None else len(pf_slots)
            pf_tok = np.zeros((n, C), np.int32)
            pf_qpos = np.zeros((n, C), np.int32)
            pf_wpos = np.full((n, C), _DROP_POS, np.int32)
            for s in chunk_rows:
                i = at[s]
                p0 = int(self._pf_pos[s])
                v = int(min(C, self._pf_end[s] - p0))
                pf_tok[i, :v] = self.active[s].prompt[p0:p0 + v]
                pf_qpos[i, :] = p0 + np.arange(C)
                pf_wpos[i, :v] = p0 + np.arange(v)
                valid[s] = (i, v)
            pf = tuple(torch.from_numpy(x).to(dev)
                       for x in (pf_tok, pf_qpos, pf_wpos))
        last_tok = torch.from_numpy(self._last_tok).to(dev)
        frozen_t = torch.from_numpy(frozen).to(dev)
        if self.bucketed_dispatch:
            # every active slot rides the decode bucket (prefilling and
            # paused rows too: the decode-then-chunk ordering needs their
            # lanes); vacant slots stay out
            kb = self._dispatch_cache.bucket(len(self.active))
            rows = self._dispatch_cache.pad_rows(sorted(self.active), kb)
            out = self._bucket_round(view, rows, last_tok, frozen_t, pf,
                                     steps, pf_slots)
        else:
            out = self._round(view, last_tok, frozen_t, pf, steps)
        self._clock.mark("dispatch_end")
        return (*out, valid)

    # ------------------------------------------------------------ decode loop
    def step(self) -> int:
        """One scheduler round: apply round-boundary cancellations and
        queue expiries, re-tune the allocator's wait strategy (paged),
        admit per the Algorithm-5 plan, prepare pages, dispatch, retire.
        A failed dispatch is retried with linear backoff; the request
        blamed ``quarantine_after`` times in a row is quarantined, and
        the attempt cap bounds even a round that always fails (every
        failure advances some rid's streak). Errors of the kernel layer
        and of the CUDA runtime are not retried. Returns the number of
        still-active requests.

        The round's host phases tile it on the phase clock (``stats()``'s
        ``span_*_s``; ranges ``serve.*`` while a profiler records): prep
        up to the dispatch, the dispatch's input building and launches,
        the fetch of its tokens, and the bookkeeping after."""
        self._clock.begin("prep")
        try:
            return self._step()
        finally:
            self._clock.end()

    def _step(self) -> int:
        self._apply_cancels()
        self._expire_queued()
        if self.paged:
            self.pool.retune()
        with span("serve.admit"):
            self._admit()
        if not self.active:
            self._flush_deferred_frees()
            return 0
        attempts = 0
        max_attempts = self.quarantine_after * (len(self.active) + 1)
        while True:
            try:
                n = self._run_round()
            except (InjectedFault, RoundDispatchError) as exc:
                self._clock.switch("prep")
                attempts += 1
                self.rounds_retried += 1
                self._recover_round(exc)
                if not self.active:
                    self._flush_deferred_frees()
                    return 0
                if attempts >= max_attempts:
                    raise
                if self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s * attempts)
                continue
            self._round_failures.clear()
            return n

    def _run_round(self) -> int:
        steps = self.decode_chunk
        C = self.prefill_chunk
        planned: List[int] = []
        if C:
            backlog = sorted((s for s in self.active if self._prefilling(s)),
                             key=lambda s: self.active[s].rid)
            decode_rows = [s for s in self.active
                           if not self._prefilling(s)]
            planned = plan_round(
                self.round_token_budget, decode_rows, backlog,
                chunk_tokens=C, decode_chunk=steps,
                deprioritized=[s for s in backlog if self._late(s)],
                remaining={s: int(self._pf_end[s] - self._pf_pos[s])
                           for s in backlog}).chunk_rows
        if self.paged:
            with span("serve.pages"):
                paused, advancing = self._grow_for_chunk(steps,
                                                         tuple(planned))
        else:
            paused, advancing = set(), set(planned)
        if not self.active:                    # everything preempted away
            self._flush_deferred_frees()
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
        self._clock.switch("dispatch")
        # the generator is the only host state the dispatch consumes:
        # restoring it on failure makes the retry replay the same draws
        gen0 = self._gen.get_state()
        try:
            if self.fault_plan is not None:
                self.fault_plan.dispatch(
                    [r.rid for r in self.active.values()])
            cache, tok, toks, pf_logits, valid = self._dispatch(
                view, frozen, chunk_rows, steps)
        except InjectedFault:
            self._gen.set_state(gen0)
            raise
        except Exception as exc:
            self._gen.set_state(gen0)
            if is_device_error(exc):
                raise
            raise RoundDispatchError(exc) from exc
        self.decode_dispatches += 1
        self.decode_steps_run += steps
        self.pool.adopt(cache)
        self._clock.switch("fetch")
        self._last_tok = tok.cpu().numpy().astype(np.int32)
        toks = toks.cpu().numpy()                          # [steps, K]
        self._clock.read_marks()
        self._clock.switch("post")

        if chunk_rows:
            self.prefill_lanes_computed += C * (
                self._dispatch_cache.bucket(len(chunk_rows))
                if self.bucketed_dispatch else self.capacity)
        completions: List[Tuple[int, int, int]] = []
        for s in chunk_rows:
            i, v = valid[s]
            self._pf_pos[s] += v
            self.prefill_chunks += 1
            self.prefill_tokens += v
            self.pad_tokens += C - v
            self.active[s].prefill_chunks += 1
            if self._pf_pos[s] >= self._pf_end[s]:
                completions.append((s, i, v))
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
        for s, i, v in completions:
            # prompt fully cached: the first output token comes from the
            # chunk's last real lane (prefilling -> decoding)
            req = self.active[s]
            tok0 = int(self._sample(pf_logits[i, v - 1][None])[0])
            self._last_tok[s] = tok0
            req.out_tokens.append(tok0)
            if self.eos_id is not None and tok0 == self.eos_id:
                req.eos = True
            if self.paged and self.prefix_sharing:
                self.prefix_index.register(
                    req.prompt, 0,
                    self.pool.page_ids(
                        s, self.pool.pages.pages_for(int(self._pf_end[s]))),
                    schedule=self.prefill_chunk)
            self._pf_pos[s] = 0
            self._pf_end[s] = 0
            req.state = RequestState.DECODING
            req.decode_start_step = self.step_clock
            if req.eos or self._steps_left[s] <= 0:
                retire.append((s, 0))
        # live generated-boundary registration (cache on, chunked): as a
        # decoding conversation crosses page boundaries, its prompt +
        # reply full pages enter the live index, so a fork adopts them
        # while the donor is still active
        reg_gen = (self.prefix_cache is not None and self.prefix_sharing
                   and self.prefill_chunk > 0)
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
            elif reg_gen:
                self._register_generated(slot, req)
        with span("serve.retire"):
            self._retire_batch(retire)
        self.step_clock += steps
        return len(self.active)

    def _register_generated(self, slot: int, req: ServeRequest) -> None:
        ps = self.pool.page_size
        n_full = (int(req.prompt.size) + len(req.out_tokens) - 1) // ps
        if n_full > int(self._gen_reg[slot]):
            written = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
            self.prefix_index.register(written[:n_full * ps], 0,
                                       self.pool.page_ids(slot, n_full),
                                       schedule=self.prefill_chunk)
            self._gen_reg[slot] = n_full

    def run_until_done(self, max_rounds: int = 1_000_000) -> int:
        """Drain queue + active set. Returns scheduler rounds used."""
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            self.step()
            rounds += 1
        return rounds

    def drop_prefix_cache(self) -> int:
        """Release every page the prefix cache retains (one
        ``free_batch``); returns the references dropped. After it an idle
        engine's pool must be empty — the leak check's drain."""
        if self.prefix_cache is None:
            return 0
        groups = self.prefix_cache.drop_all()
        if groups:
            self._free_batch_safe(groups)
        return int(sum(g.size for g in groups))

    # -------------------------------------------------------------- reporting
    def stats(self) -> Dict[str, float]:
        """Aggregate serving counters (the reference's keys; all floats;
        the allocator's only on the paged layout). ``finished`` counts
        FINISHED requests, ``terminal`` every terminal one; ``tokens``
        every token delivered, a cancelled stream's prefix included. The
        fault counters are structurally 0 in a fault-free run. Wait and
        time-in-state percentiles are over granted terminal requests."""
        term = self.finished
        fin = [r for r in term if r.state is RequestState.FINISHED]
        granted = [r for r in term if r.grant_step >= 0]
        waits = np.asarray([r.wait_steps for r in granted], np.float32)
        waits_s = np.asarray([r.wait_s for r in granted], np.float32)
        toks = int(sum(len(r.out_tokens) for r in term))
        now_s = time.perf_counter()

        def pctl(vals, q):
            arr = np.asarray(vals, np.float32)
            return float(np.percentile(arr, q)) if arr.size else 0.0

        q_steps = [r.queued_steps for r in granted]
        pf_steps = [r.prefill_steps for r in granted]
        dec_steps = [r.decode_steps for r in granted]
        out = {
            "finished": float(len(fin)),
            "terminal": float(len(term)),
            "cancelled": float(self.cancellations),
            "expired": float(self.expiries),
            "failed": float(sum(
                1 for r in term if r.state is RequestState.FAILED)),
            "faults_injected": float(
                self.fault_plan.injected if self.fault_plan else 0),
            "rounds_retried": float(self.rounds_retried),
            "requests_quarantined": float(self.requests_quarantined),
            "tokens": float(toks),
            "decode_dispatches": float(self.decode_dispatches),
            "decode_steps": float(self.decode_steps_run),
            "p50_wait_steps": pctl(waits, 50),
            "p99_wait_steps": pctl(waits, 99),
            "p50_wait_s": pctl(waits_s, 50),
            "p99_wait_s": pctl(waits_s, 99),
            "queue_depth": float(len(self.queue)),
            "active_rows": float(len(self.active)),
            "p50_queued_steps": pctl(q_steps, 50),
            "p99_queued_steps": pctl(q_steps, 99),
            "p50_prefill_steps": pctl(pf_steps, 50),
            "p99_prefill_steps": pctl(pf_steps, 99),
            "p50_decode_steps": pctl(dec_steps, 50),
            "p99_decode_steps": pctl(dec_steps, 99),
            "deadline_rows": float(sum(
                1 for r in self.active.values()
                if r.deadline_step is not None or r.deadline_s is not None)),
            "late_rows": float(sum(
                r.past_deadline(self.step_clock, now_s)
                for r in self.active.values())),
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
            "decode_rounds_stalled_by_prefill": float(
                self.decode_rounds_stalled_by_prefill),
            "attention_fused": float(self.attention_impl == "fused"),
            "bucketed_dispatch": float(self.bucketed_dispatch),
            "dispatch_shapes": float(len(self._dispatch_cache.shapes)
                                     if self._dispatch_cache else 0),
            "prefill_lanes_computed": float(self.prefill_lanes_computed),
        }
        # the phase clock: host seconds of each phase of ``step`` and
        # device-clock seconds of the dispatch's spans
        out.update({f"span_{k}_s": v
                    for k, v in self._clock.host_s.items()})
        out.update({f"span_{k}_device_s": v
                    for k, v in self._clock.device_s.items()})
        if not self.paged:
            return out
        pp = self.pool.pages
        ls = pp.lock_stats()
        out.update({
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
            "watchdog_trips": float(ls.get("watchdog_trips", 0)),
            "aborted_batches": float(pp.aborted_batches),
            "per_page_lock_acquires": float(pp.pages_alloced
                                            + pp.pages_freed),
            "per_page_lock_acquires_per_token": (
                float(pp.pages_alloced + pp.pages_freed)
                / float(max(toks, 1))),
            # prefix sharing's currency: physical page grants per token
            "pages_alloced": float(pp.pages_alloced),
            "pages_per_token": (float(pp.pages_alloced)
                                / float(max(toks, 1))),
            "page_increfs": float(pp.increfs),
            "page_decrefs": float(pp.decrefs),
            "prefix_sharing": float(self.prefix_sharing),
            "prefix_hits": float(self.prefix_hits),
            "shared_pages_adopted": float(self.shared_pages_adopted),
            "cow_splits": float(self.cow_splits),
            "prefix_cache": float(self.prefix_cache is not None),
            "cache_hit_rate": (
                float(self.prefix_cache.hits)
                / float(max(self.prefix_cache.hits
                            + self.prefix_cache.misses, 1))
                if self.prefix_cache is not None else 0.0),
            "cache_hits": float(self.cache_hits),
            "cache_tokens_served": float(self.cache_tokens_served),
            "prefill_tokens_saved": float(self.prefill_tokens_saved),
        })
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out

    def slot_deadlines(self) -> Dict[int, Dict[str, float]]:
        """Per-slot deadline metadata of the in-flight rows: rid, state,
        absolute step deadline (-1: none), steps of slack on the step
        clock (negative once late) and whether the row is late now."""
        now_s = time.perf_counter()
        out: Dict[int, Dict[str, float]] = {}
        for slot, req in sorted(self.active.items()):
            dl = req.deadline_step
            out[slot] = {
                "rid": float(req.rid),
                "state": req.state.value,
                "deadline_step": float(dl if dl is not None else -1),
                "slack_steps": (float(dl - self.step_clock)
                                if dl is not None else float("inf")),
                "late": bool(req.past_deadline(self.step_clock, now_s)),
            }
        return out
