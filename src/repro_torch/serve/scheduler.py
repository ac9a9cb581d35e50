"""Continuous-batching admission scheduler built on the paper's semaphore
(counterpart of ``repro.serve.scheduler``).

The serving fleet has a hard concurrency budget (KV-cache slots per
replica). Admission control under that budget is *exactly* a counting
semaphore, and the paper's two findings drive the design:

  * the **sleeping (FA) semaphore** is the right primitive: one atomic per
    under-capacity admission, FIFO-fair handoff — no starved requests, no
    thundering herd on a slot release (the spin semaphore's failure mode);
  * admission *planning* is deterministic given FIFO fairness, so the
    scheduler can run the paper's Algorithm-5 timeline as a kernel
    (kernels/semaphore.py, CUDA on the card) to predict grant/completion
    times for a queue and size batches ahead of time.

Every primitive is reached through an injected ``sync.SyncLibrary``
— no direct imports of hostsync or the kernel ops — so the live gate's
algorithm (sleeping vs spin, the spin-vs-sleep admission knob) and the
planner's backend (CUDA kernel / plain version) are configuration, not
code. ``AdmissionController`` is the host-side gate;
``plan_admission`` is the planner used for batching decisions and
reported in benchmarks/serving; ``plan_round`` splits a round's token
budget between decode rows and prefill chunks; ``ContinuousBatcher`` is
the step-level batcher the slot engine grew out of.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sync import SemaphorePlan, SyncLibrary


def plan_admission(arrivals_s: np.ndarray, service_s: np.ndarray,
                   capacity: int, *, lib: Optional[SyncLibrary] = None,
                   device=None) -> SemaphorePlan:
    """Deterministic Algorithm-5 timeline for a FIFO request queue,
    planned on ``device``'s planner: the CUDA kernel on ``cuda`` (the
    default, which raises without a card), its plain version on
    ``cpu``."""
    lib = lib if lib is not None else SyncLibrary.host_default()
    return lib.plan_semaphore(arrivals_s, service_s, capacity,
                              backend=lib.planning_backend_name(device))


def allocator_contention(capacity: int, service_steps: float,
                         round_events: float = 3.0) -> float:
    """Expected contention on the KV page allocator's mutex, for
    ``select_impl``'s wait-strategy relaxation (paper Section 6).

    Since the batched-allocation rework (DESIGN.md §10) the allocator is
    entered at most ``round_events`` times per scheduler round — one
    admission grant, one growth top-up, one retirement reclaim — no
    matter how many requests or pages the round moves, so the entrant
    rate per participant is ``round_events / service`` spread over the K
    slots the round serves. Long-lived requests make the allocator a
    low-contention lock — the selector then relaxes toward cheaper spin
    waits; pathological churn (service of a step or two at K=1)
    saturates it. The pre-batching estimate was ``2K / service``
    critical sections per step — per-request admission and retirement —
    which this strictly lower-bounds.

    Copy-on-write prefix sharing (DESIGN.md §11) does not change the
    estimate: adoption increfs ride the admission grant's critical
    section (``alloc_batch(incref_groups=)``), CoW split grants and
    their source decrefs ride the growth top-up's
    (``prepare_batch``/``paired_decrefs``), and retirement decrefs
    *are* the retirement reclaim — the same ≤ ``round_events`` entries
    per round, with or without sharing.
    """
    if capacity < 1:
        return 0.0
    return float(min(1.0, round_events
                 / max(float(service_steps), 1.0)
                 / float(capacity)))


class AdmissionController:
    """Host-side concurrency gate: FIFO-fair semaphore from the library.

    The semaphore algorithm comes from the injected ``SyncLibrary``'s
    selection (or its ``semaphore_kind`` pin / the ``kind`` override):
    "sleeping" for the paper's Algorithm-5 FA semaphore, "spin" /
    "spin_backoff" for the Algorithm-4 baseline.
    """

    def __init__(self, capacity: int, lib: Optional[SyncLibrary] = None,
                 kind: Optional[str] = None):
        self.capacity = capacity
        self.lib = lib if lib is not None else SyncLibrary.host_default()
        self._sem = self.lib.semaphore(capacity, kind=kind)
        self.kind = type(self._sem).__name__
        self.admitted = 0
        self.completed = 0

    def acquire_slot(self, timeout: Optional[float] = None) -> bool:
        """Algorithm-5 wait(): blocks (FIFO-fairly) until a slot is free.

        The slot engine calls this on its admission hot path — one
        fetch-and-add when under capacity, ticket + handoff when over —
        so the semaphore count is the ground truth for slot occupancy.
        """
        if not self._sem.wait(timeout=timeout):
            return False
        self.admitted += 1
        return True

    def release_slot(self) -> None:
        """Algorithm-5 post(): hand the slot to the oldest waiter."""
        self.completed += 1
        self._sem.post()

    @property
    def in_flight(self) -> int:
        return self.admitted - self.completed

    def run_request(self, work: Callable[[], None],
                    timeout: Optional[float] = None) -> bool:
        if not self.acquire_slot(timeout=timeout):
            return False
        try:
            work()
        finally:
            self.release_slot()
        return True


@dataclasses.dataclass
class RoundPlan:
    """One scheduler round's token-budget split (``plan_round``)."""
    decode_tokens: int          # tokens the round's decode rows consume
    chunk_rows: List[int]       # FIFO prefix of the backlog granted a chunk
    deferred: int               # backlog rows the budget pushed to next round

    @property
    def chunk_tokens_planned(self) -> int:
        return 0 if not self.chunk_rows else len(self.chunk_rows)


def plan_round(budget: int, decode_rows: Sequence[int],
               prefill_backlog: Sequence[int], *, chunk_tokens: int,
               decode_chunk: int = 1,
               deprioritized: Sequence[int] = (),
               remaining: Optional[Dict[int, int]] = None) -> RoundPlan:
    """Fill one round's token budget: decode rows first, then fixed-size
    prefill chunks from the partially-prefilled backlog.

    Decode rows are never displaced — every in-flight decode advances
    ``decode_chunk`` tokens each round regardless of the budget (the
    budget throttles *prefill* admission into the dispatch, which is
    what keeps a long prompt from monopolizing rounds). The leftover
    budget funds ``chunk_tokens``-sized prefill chunks, granted to the
    FIFO prefix of ``prefill_backlog`` — callers pass the backlog in
    admission-grant order, so the semaphore's FIFO grant order is never
    jumped: a younger prefill cannot advance while an older one is
    deferred. Progress guarantee: when nothing is decoding, at least one
    backlog row always chunks (a budget below ``decode_tokens +
    chunk_tokens`` must throttle, not deadlock).

    ``deprioritized`` names backlog rows that are past their request's
    deadline (DESIGN.md §13): they move behind every on-time row —
    keeping their relative FIFO order — so a late prompt only consumes
    chunk budget no on-time prompt could use. This is the one sanctioned
    exception to the FIFO grant order, and it is scoped to *chunk
    scheduling among already-admitted rows*: the admission semaphore's
    FIFO is untouched, and an over-deadline request is never starved
    outright — when only late rows remain they chunk in FIFO order, and
    the idle-round progress guarantee applies to them too.

    ``remaining`` maps a backlog row to the prompt tokens it actually
    has left to prefill. A row whose remainder is under ``chunk_tokens``
    — the final partial chunk, or a prompt largely served from the
    prefix cache — is charged only its real cost, so a cache-shortened
    prefill never blocks budget a deeper backlog row could have used.
    Rows absent from the map (or with a larger remainder) cost a full
    chunk, exactly as before.
    """
    if chunk_tokens < 1:
        raise ValueError("chunk_tokens must be >= 1")
    decode_tokens = len(decode_rows) * max(decode_chunk, 1)
    backlog = list(prefill_backlog)
    late = set(deprioritized)
    if late:
        backlog = ([r for r in backlog if r not in late]
                   + [r for r in backlog if r in late])
    if not backlog:
        return RoundPlan(decode_tokens, [], 0)

    def cost(row: int) -> int:
        if remaining is None:
            return chunk_tokens
        return max(1, min(chunk_tokens, int(remaining.get(row,
                                                          chunk_tokens))))

    left = max(0, int(budget) - decode_tokens)
    rows: List[int] = []
    for r in backlog:                       # greedy FIFO walk, no skips
        c = cost(r)
        if c > left:
            break
        rows.append(r)
        left -= c
    if not rows and not decode_rows:
        rows = backlog[:1]                  # progress guarantee
    return RoundPlan(decode_tokens, rows, len(backlog) - len(rows))


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival_s: float = 0.0
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    output: Optional[np.ndarray] = None


class ContinuousBatcher:
    """Step-level batcher: admit up to capacity, decode together, retire.

    ``decode_fn(batch_ids) -> finished_mask`` abstracts the engine; the
    batcher owns FIFO admission (ticket order == arrival order) and slot
    recycling: a request leaves when ``decode_fn`` flags it or its
    ``max_new_tokens`` steps are spent, and its ``done`` event is set.
    """

    def __init__(self, capacity: int,
                 decode_fn: Callable[[List[int]], List[bool]]):
        self.capacity = capacity
        self.decode_fn = decode_fn
        # deque: admission pops the FIFO head in O(1)
        self.queue: Deque[Request] = collections.deque()
        self.active: List[Request] = []
        self.finished: List[Request] = []
        self._steps_left: Dict[int, int] = {}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def step(self) -> int:
        """One scheduler tick. Returns the number of active sequences."""
        # admit FIFO while there is capacity (the semaphore discipline)
        while self.queue and len(self.active) < self.capacity:
            req = self.queue.popleft()
            self.active.append(req)
            self._steps_left[req.rid] = req.max_new_tokens
        if not self.active:
            return 0
        finished = self.decode_fn([r.rid for r in self.active])
        still = []
        for r, f in zip(self.active, finished):
            self._steps_left[r.rid] -= 1
            if f or self._steps_left[r.rid] <= 0:
                r.done.set()
                self.finished.append(r)
            else:
                still.append(r)
        self.active = still
        return len(self.active)

    def drain(self, max_ticks: int = 1_000_000) -> int:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
