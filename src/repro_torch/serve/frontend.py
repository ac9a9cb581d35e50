"""Async streaming front-end: the open-loop request lifecycle surface
(counterpart of ``repro.serve.frontend``).

Everything before this module drove the serve engine closed-loop — a
caller submits N prompts and waits for the drain. Production traffic is
an *open loop*: concurrent clients arrive on their own clock, consume
tokens as they are produced, hang up mid-stream, and carry latency
SLOs. :class:`AsyncFrontend` owns that lifecycle end to end (DESIGN.md
§13):

  * each :meth:`~AsyncFrontend.submit` returns a :class:`StreamHandle`
    — an async iterator the client consumes token-by-token as decode
    rounds complete, plus a cancel handle and the request's lifecycle
    state (``QUEUED → PREFILLING → DECODING → {FINISHED, CANCELLED,
    EXPIRED}``, engine-owned);
  * **backpressure rides the existing admission semaphore**: the
    front-end never admits anything itself — it feeds the engine's FIFO
    queue and the Algorithm-5 gate decides, in grant order, exactly as
    before. What the front-end adds is a *bounded intake*: when the
    not-yet-granted population (intake + engine queue) reaches
    ``intake_limit``, ``submit`` sheds the request explicitly
    (:class:`IntakeFullError`) instead of queueing unboundedly — load
    shedding is a visible event, not an OOM;
  * **cancellation** marks the request and lets the engine retire it at
    the next round boundary through the existing evict/free path — the
    slot and its semaphore grant free before that round's admission,
    and the pages (including CoW-shared prefix pages, which decref)
    ride the round's one retirement ``free_batch``: zero new allocator
    acquires, zero leaks (``SlotServeEngine.cancel``);
  * **deadlines** flow into the engine (absolute step-clock and/or
    wall-clock): a queued request past its deadline is shed as
    EXPIRED, an active one turns *late* — deprioritized for prefill
    chunk grants (``scheduler.plan_round(deprioritized=...)``) and
    first in line for page-pressure eviction.

The round loop bridges the sync engine to async consumers: each
scheduler round runs in the default executor (``engine.step`` holds the
round's device work; the engine names its device on every tensor it
makes, so the executor thread needs no current-device setting, and it
launches on the same default stream), and between rounds — on the
event-loop thread, with the engine guaranteed idle — the front-end
transfers intake, forwards cancellations, and pumps freshly decoded
tokens into the per-request stream queues. All engine mutation therefore happens either inside
``engine.step`` or between rounds on one thread: no locks, no races.

Tokens are pumped from the host-side ``out_tokens`` of each request:
the pump reads nothing from the device. Minimal client (the launcher's
``--open-loop`` is the full demo)::

    async with AsyncFrontend(engine) as fe:
        handle = await fe.submit(prompt, max_new_tokens=32,
                                 deadline_s=0.5)
        async for token in handle:        # tokens as rounds complete
            consume(token)
        print(handle.state, handle.ttft_s)
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import (RequestState, ServeRequest,
                                     SlotServeEngine)
from repro_torch.serve.faults import FaultPlan, InjectedFault


class IntakeFullError(RuntimeError):
    """The bounded intake queue is full: the request was shed.

    Raised by :meth:`AsyncFrontend.submit` when the not-yet-granted
    population has reached ``intake_limit``. Clients retry with backoff
    or report overload upstream; the front-end never queues past the
    bound."""


class RequestFailedError(RuntimeError):
    """The request was quarantined by the engine (FAILED terminal,
    DESIGN.md §15).

    Raised by the stream iterator *after* delivering every token the
    request produced before failing — the client keeps the partial
    stream and gets a typed error instead of a silent end."""


class StreamHandle:
    """One request's client-side surface: an async token stream, a
    cancel handle, and the lifecycle state.

    Iterate to consume (``async for token in handle``); the iterator
    ends when the request reaches a terminal state. ``cancel()`` is
    fire-and-forget and safe from any state — tokens stop immediately,
    the engine reclaims the slot and pages at the next round boundary.
    """

    def __init__(self, frontend: "AsyncFrontend", prompt: np.ndarray,
                 max_new_tokens: int, deadline_steps: Optional[int],
                 deadline_s: Optional[float]):
        self._frontend = frontend
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        #: relative deadlines as given to submit(); bound to absolute
        #: clocks when the request enters the engine
        self.deadline_steps = deadline_steps
        self.arrival_s = time.perf_counter()
        self.deadline_abs_s = (self.arrival_s + deadline_s
                               if deadline_s is not None else None)
        self.first_token_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        #: the engine-side request, bound when intake transfers into
        #: the engine queue (None while still in intake)
        self.req: Optional[ServeRequest] = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._streamed = 0          # tokens already pushed to the queue
        self._cancel_requested = False
        self._closed = False        # sentinel delivered
        self._state_override: Optional[RequestState] = None
        #: set when the engine quarantined this request (FAILED): the
        #: iterator raises :class:`RequestFailedError` at stream end
        self.error: Optional[str] = None

    # ------------------------------------------------------------- inspection
    @property
    def rid(self) -> Optional[int]:
        return self.req.rid if self.req is not None else None

    @property
    def state(self) -> RequestState:
        """Lifecycle state: the engine request's once bound, QUEUED
        while still in intake (or CANCELLED if torn down there)."""
        if self._state_override is not None:
            return self._state_override
        if self.req is None:
            return RequestState.QUEUED
        return self.req.state

    @property
    def done(self) -> bool:
        return self.state.terminal

    @property
    def out_tokens(self) -> List[int]:
        """Tokens streamed to this client so far (a cancelled stream
        keeps the prefix it received)."""
        if self.req is None:
            return []
        return list(self.req.out_tokens[:self._streamed])

    @property
    def ttft_s(self) -> Optional[float]:
        """Wall-clock time-to-first-token (None until the first token
        arrives — or forever, for shed/expired/never-granted streams).
        The open-loop SLO currency: measured from ``submit``, so it
        includes queueing, admission, and prefill."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    # -------------------------------------------------------------- lifecycle
    def cancel(self) -> None:
        """Tear the stream down. Idempotent; a no-op once terminal.
        Tokens stop at once, and the engine frees the slot + pages at
        the next round boundary (zero new allocator acquires)."""
        if self._cancel_requested or self.done:
            return
        self._cancel_requested = True
        self._frontend._note_cancel(self)

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> int:
        item = await self._queue.get()
        if item is None:
            if self.error is not None:
                raise RequestFailedError(self.error)
            raise StopAsyncIteration
        return item

    async def collect(self) -> List[int]:
        """Drain the stream to completion; returns every token.
        Raises :class:`RequestFailedError` (after the partial stream
        was consumed) when the request was quarantined."""
        return [tok async for tok in self]


class AsyncFrontend:
    """Open-loop asyncio front-end over a :class:`SlotServeEngine`.

    The front-end owns the engine's round loop while running — do not
    call ``engine.step`` / ``engine.submit`` concurrently. Use as an
    async context manager, or ``start()`` / ``await aclose()``.

    ``intake_limit`` bounds the not-yet-granted population (front-end
    intake + engine FIFO queue); past it, ``submit`` raises
    :class:`IntakeFullError` (counted in ``shed``). The engine's
    admission semaphore remains the sole grant authority — the bound
    only decides how much ungranted queue the process will hold.
    """

    def __init__(self, engine: SlotServeEngine, *,
                 intake_limit: int = 256, round_hook=None,
                 fault_plan: Optional[FaultPlan] = None):
        if intake_limit < 1:
            raise ValueError("intake_limit must be >= 1")
        self.engine = engine
        self.intake_limit = intake_limit
        #: deterministic injection (DESIGN.md §15): the front-end
        #: consults the ``executor`` site before handing each round to
        #: the thread pool — an injected death is recovered by retrying
        #: the round (the engine never started it). Defaults to the
        #: engine's own plan so one seed drives the whole stack.
        self._fault_plan = (fault_plan if fault_plan is not None
                            else getattr(engine, "fault_plan", None))
        self.executor_faults = 0    # injected executor deaths survived
        #: optional ``async def hook(frontend)`` awaited after every
        #: engine round (post-pump). The loop does not start the next
        #: round until it returns, so a client coroutine woken by a
        #: freshly pumped token acts *before* the following round —
        #: deterministic mid-flight cancellation for tests, per-round
        #: tracing for observability. None (default) skips the await.
        self.round_hook = round_hook
        self._intake: Deque[StreamHandle] = collections.deque()
        self._live: Dict[int, StreamHandle] = {}       # rid -> handle
        self._cancels: List[StreamHandle] = []
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._closing = False
        self.shed = 0               # submits refused at the intake bound
        self.rounds = 0             # engine rounds this front-end pumped

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "AsyncFrontend":
        """Start the round loop on the running event loop."""
        if self._task is not None and not self._task.done():
            return self
        self._closing = False
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._drive())
        return self

    async def __aenter__(self) -> "AsyncFrontend":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Drain in-flight work, then stop the round loop."""
        self._closing = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def drain(self) -> None:
        """Wait until every submitted request reached a terminal state
        (the front-end keeps running — new submits stay welcome)."""
        while self._intake or self._live or self._cancels:
            await asyncio.sleep(0.001)

    # ------------------------------------------------------------ submission
    @property
    def pending(self) -> int:
        """Requests submitted but not yet granted a slot (intake +
        engine FIFO queue) — what ``intake_limit`` bounds."""
        return len(self._intake) + len(self.engine.queue)

    async def submit(self, prompt, max_new_tokens: int, *,
                     deadline_steps: Optional[int] = None,
                     deadline_s: Optional[float] = None) -> StreamHandle:
        """Submit a request; returns its :class:`StreamHandle`.

        ``deadline_steps`` is relative to the engine's step clock at
        entry; ``deadline_s`` is relative wall-clock seconds from now.
        Either (or both) arm the SLO machinery; None leaves the request
        deadline-free. Raises :class:`IntakeFullError` when the intake
        bound would be exceeded — explicit load shedding."""
        if self._task is None or self._task.done():
            raise RuntimeError("AsyncFrontend is not running — use "
                               "'async with AsyncFrontend(engine)' or "
                               "call start() first")
        if self.pending >= self.intake_limit:
            self.shed += 1
            raise IntakeFullError(
                f"intake full: {self.pending} ungranted requests at "
                f"limit {self.intake_limit}")
        handle = StreamHandle(self, np.asarray(prompt, np.int32),
                              int(max_new_tokens), deadline_steps,
                              deadline_s)
        self._intake.append(handle)
        self._wake.set()
        return handle

    def _note_cancel(self, handle: StreamHandle) -> None:
        self._cancels.append(handle)
        if self._wake is not None:
            self._wake.set()

    # ------------------------------------------------------------ round loop
    def _transfer_intake(self) -> None:
        """Move intake into the engine's FIFO queue (between rounds, on
        the loop thread — the engine is idle). Cancel-before-transfer
        never touches the engine at all."""
        while self._intake:
            h = self._intake.popleft()
            if h._cancel_requested:
                h._state_override = RequestState.CANCELLED
                self._finish_handle(h)
                continue
            deadline_step = (self.engine.step_clock + h.deadline_steps
                             if h.deadline_steps is not None else None)
            h.req = self.engine.submit(h.prompt, h.max_new_tokens,
                                       deadline_step=deadline_step,
                                       deadline_s=h.deadline_abs_s)
            self._live[h.req.rid] = h

    def _apply_cancels(self) -> None:
        """Forward requested cancellations to the engine (it applies
        them at the next round boundary). Handles still in intake are
        resolved by ``_transfer_intake``."""
        if not self._cancels:
            return
        cancels, self._cancels = self._cancels, []
        for h in cancels:
            if h.req is not None and not h.req.state.terminal:
                self.engine.cancel(h.req.rid)

    def _finish_handle(self, handle: StreamHandle) -> None:
        if handle._closed:
            return
        handle._closed = True
        handle.finish_s = time.perf_counter()
        if (handle.req is not None
                and handle.req.state is RequestState.FAILED):
            handle.error = handle.req.error or "request failed"
        handle._queue.put_nowait(None)          # stream sentinel

    def _pump(self) -> None:
        """Push freshly decoded tokens into each live stream and close
        the handles whose requests went terminal this round."""
        now = time.perf_counter()
        for rid in list(self._live):
            h = self._live[rid]
            req = h.req
            toks = req.out_tokens
            if len(toks) > h._streamed and not h._cancel_requested:
                if h.first_token_s is None:
                    h.first_token_s = now
                for t in toks[h._streamed:]:
                    h._queue.put_nowait(int(t))
                h._streamed = len(toks)
            if req.state.terminal:
                self._finish_handle(h)
                del self._live[rid]

    async def _drive(self) -> None:
        """The round pump. Each iteration: apply cancels, transfer
        intake, run one engine round in the executor, pump tokens.
        Engine state is only ever touched here (between rounds) or
        inside ``engine.step`` — single-writer by construction."""
        loop = asyncio.get_running_loop()
        eng = self.engine
        try:
            while True:
                self._apply_cancels()
                self._transfer_intake()
                if eng.queue or eng.active or eng._cancel_pending:
                    if self._fault_plan is not None:
                        try:
                            self._fault_plan.executor()
                        except InjectedFault:
                            # executor death before the step started:
                            # the engine never ran, so recovery is a
                            # plain retry of the round
                            self.executor_faults += 1
                            await asyncio.sleep(0)
                            continue
                    await loop.run_in_executor(None, eng.step)
                    self.rounds += 1
                    self._pump()
                    if self.round_hook is not None:
                        await self.round_hook(self)
                    continue
                self._pump()                    # flush terminal handles
                if self._closing and not (self._intake or self._cancels):
                    break
                self._wake.clear()
                if self._intake or self._cancels or self._closing:
                    continue
                await self._wake.wait()
        finally:
            # never strand a consumer on a silent queue
            self._pump()
            for h in list(self._live.values()):
                self._finish_handle(h)
            self._live.clear()
            for h in self._intake:
                h._state_override = RequestState.CANCELLED
                self._finish_handle(h)
            self._intake.clear()

    # -------------------------------------------------------------- reporting
    def stats(self) -> Dict[str, float]:
        """Engine stats plus the front-end's open-loop ledger."""
        out = dict(self.engine.stats())
        out.update({
            "frontend_shed": float(self.shed),
            "frontend_rounds": float(self.rounds),
            "frontend_pending": float(self.pending),
            "frontend_live": float(len(self._live)),
            "frontend_executor_faults": float(self.executor_faults),
        })
        return out
