"""Drive the program's serving engine with a mix's traffic and record,
on the host clock, every round and every token.

The closed loop calls ``SlotServeEngine.step`` itself; the open loop
hands the engine to ``serve.frontend.AsyncFrontend`` and submits on the
Poisson schedule. Either way every ``engine.step`` runs inside the
harness's span (:class:`Rounds`), and each token is stamped with the
end of the round that produced it: the round ends in a copy of its
tokens to the host, so the stamp is when the token exists there.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench import flops
from bench.traffic import ClosedTraffic, OpenTraffic, Request


@dataclasses.dataclass
class Rec:
    """One request as the harness sees it."""
    spec: Request
    due: float                      # when it was due (perf_counter)
    submit: float = math.nan        # when it was handed to the program
    req: Any = None                 # the engine's ServeRequest
    handle: Any = None              # the frontend's StreamHandle (open)
    times: List[float] = dataclasses.field(default_factory=list)
    shed: bool = False

    def engine_req(self):
        if self.handle is not None:
            return self.handle.req
        return self.req


class Rounds:
    """The harness's span around every ``engine.step``: start, end and the
    engine's ``prefill_chunks`` counter after each round. Once ``trace``
    is set to ``(first round, rounds)``, those rounds run under
    ``torch.profiler``."""

    def __init__(self, engine):
        self.engine = engine
        self._step = engine.step
        self.t0: List[float] = []
        self.t1: List[float] = []
        self.chunks: List[int] = []
        self.trace: Optional[tuple] = None
        self.profiler = None
        self.profiled = (0, 0)

    def __len__(self) -> int:
        return len(self.t1)

    def step(self) -> int:
        from torch.profiler import record_function

        i = len(self.t1)
        if self.trace is not None and i == self.trace[0]:
            self._start_profiler()
        t0 = time.perf_counter()
        with record_function("bench.round"):
            n = self._step()
        t1 = time.perf_counter()
        self.t0.append(t0)
        self.t1.append(t1)
        self.chunks.append(int(self.engine.prefill_chunks))
        if (self.profiler is not None
                and i == self.trace[0] + self.trace[1] - 1):
            self.profiler.stop()
            self.profiled = (self.trace[0], i + 1)
        return n

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts, record_shapes=False,
                                with_stack=False, profile_memory=False)
        self.profiler.start()

    def in_window(self, t_open: float, t_close: float) -> List[int]:
        """Indices of the rounds that ended inside ``(t_open, t_close]``."""
        return [i for i, t in enumerate(self.t1) if t_open < t <= t_close]


@dataclasses.dataclass
class Run:
    """What a driven run leaves for the metric readers."""
    kind: str
    recs: List[Rec]
    rounds: Rounds
    t_open: float
    t_close: float
    seconds: float
    stats_open: Dict[str, float]
    stats_close: Dict[str, float]
    #: closed loop: per round, the positions the decode kernel reads per
    #: row (new token included) and the useful operations of the round
    decode_lengths: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)
    round_flops: Dict[int, float] = dataclasses.field(default_factory=dict)
    lateness: List[float] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def warm_profiler(device) -> None:
    """Start and stop the profiler once around a trivial op, so that its
    tracer's start-up is paid in set-up and not in the traced rounds.
    The profiler is started, stopped and warmed on the thread that runs
    the rounds."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
        else [])
    with profile(activities=acts):
        torch.ones(1, device=device).sum().item()


def _collect(rec: Rec, now: float) -> None:
    """Stamp the tokens ``rec`` gained in the round that just ended. A
    preempted request restarts from its prompt and regenerates the same
    stream: its tokens count again only past those already stamped."""
    req = rec.engine_req()
    if req is None:
        return
    n = len(req.out_tokens)
    if n > len(rec.times):
        rec.times.extend([now] * (n - len(rec.times)))


def run_closed(engine, traffic: ClosedTraffic, dm: Dict[str, Any],
               seconds: float, trace: Optional[tuple] = None) -> Run:
    """``traffic.clients`` callers from the start; each sends its next
    request the moment its last one ends. The first ``traffic.live``
    requests start in mid-life; the ramp prefills their contexts, and
    the window opens at the end of the first round after which none of
    them is queued or prefilling. It closes at the end of the first
    round that ends ``seconds`` later or more. ``trace`` = (seconds
    after the window opens, rounds): the run of rounds profiled."""
    from torch.profiler import record_function

    from repro_torch.serve.engine import RequestState

    PRE, DEC = RequestState.PREFILLING, RequestState.DECODING
    QUE = RequestState.QUEUED
    chunk = engine.prefill_chunk
    rounds = Rounds(engine)
    recs: List[Rec] = []
    live: Dict[int, Rec] = {}
    if trace is not None:
        warm_profiler(engine.device)

    def submit(now: float) -> None:
        spec = traffic.next()
        rec = Rec(spec, due=now, submit=now)
        rec.req = engine.submit(spec.prompt, spec.max_new_tokens)
        recs.append(rec)
        live[rec.req.rid] = rec

    t = time.perf_counter()
    for _ in range(traffic.clients):
        submit(t)
    t_open = t_close = math.nan
    run = None
    while True:
        is_open = not math.isnan(t_open)
        if is_open:
            before = {rid: (r.req.state, len(r.req.out_tokens),
                            r.req.prefill_chunks)
                      for rid, r in live.items()}
        rounds.step()
        now = rounds.t1[-1]
        i = len(rounds) - 1
        with record_function("bench.clients"):
            if is_open:
                lens, fl = [], 0.0
                for rid, (st0, n0, c0) in before.items():
                    req = live[rid].req
                    st1 = req.state
                    if not (st1 in (PRE, DEC) or st1.terminal):
                        continue        # still queued, or preempted
                    lp = int(req.prompt.size)
                    lens.append(lp + n0 if st0 is DEC else chunk * c0 + 1)
                    c1 = req.prefill_chunks
                    if c1 > c0:         # prompt positions prefilled
                        fl += flops.span_flops(dm, chunk * c0,
                                               min(chunk * c1, lp))
                    # the k-th token (k >= 2) is the decode step at
                    # position lp + k - 2
                    fl += flops.span_flops(dm, lp + max(n0, 1) - 1,
                                           lp + len(req.out_tokens) - 1)
                run.decode_lengths[i] = lens
                run.round_flops[i] = fl
            for rid in list(live):
                rec = live[rid]
                _collect(rec, now)
                if rec.req.state.terminal:
                    del live[rid]
                    submit(now)
        if (is_open and trace is not None and rounds.trace is None
                and now >= t_open + trace[0]):
            rounds.trace = (len(rounds), trace[1])
        if not is_open and not any(r.req.state in (QUE, PRE)
                                   for r in recs[:traffic.live]):
            t_open = now
            run = Run("closed", recs, rounds, t_open, math.nan, seconds,
                      engine.stats(), {})
        elif is_open and now >= t_open + seconds:
            t_close = now
            break
    if rounds.profiler is not None and rounds.profiled == (0, 0):
        rounds.profiler.stop()
        rounds.profiled = (rounds.trace[0], len(rounds))
    rounds.engine = rounds._step = None
    run.t_close = t_close
    run.stats_close = engine.stats()
    return run


def run_open(engine, traffic: OpenTraffic, warm_s: float, seconds: float,
             intake_limit: int, wait_s: float = 60.0,
             trace: Optional[tuple] = None) -> Run:
    """Requests submitted through the frontend at their due times. The
    window is ``[start + warm_s, start + warm_s + seconds)``; afterwards
    the schedule goes on until every request due in the window has its
    first token (or failed), ``wait_s`` at the most, then the live
    requests are cancelled and the frontend drains."""
    from repro_torch.serve.frontend import AsyncFrontend, IntakeFullError

    rounds = Rounds(engine)
    engine.step = rounds.step                 # the frontend's rounds too
    recs: List[Rec] = []
    live: List[Rec] = []
    state: Dict[str, Any] = {"open_round": None, "close_round": None,
                             "stats_open": {}, "stats_close": {}}
    # one thread runs every round (the frontend runs them one at a
    # time), so the profiler starts and stops where the rounds run; its
    # start-up is paid there before the schedule's clock starts
    pool = ThreadPoolExecutor(max_workers=1)
    if trace is not None:
        pool.submit(warm_profiler, engine.device).result()
    t0 = time.perf_counter()
    t_open, t_close = t0 + warm_s, t0 + warm_s + seconds
    if trace is not None:
        state["trace_at"] = t_open + trace[0]
        state["trace_n"] = trace[1]

    depth: List[tuple] = []
    frontend: Dict[str, Any] = {}
    nxt = [0]                       # the next request of the schedule

    async def submit_due(now: float) -> None:
        """Hand every request due by ``now`` to the frontend, in order."""
        fe = frontend["fe"]
        while nxt[0] < len(traffic) and t0 + traffic.due_s[nxt[0]] <= now:
            rec = Rec(traffic.request(nxt[0]),
                      due=t0 + float(traffic.due_s[nxt[0]]))
            nxt[0] += 1
            recs.append(rec)
            try:
                rec.handle = await fe.submit(rec.spec.prompt,
                                             rec.spec.max_new_tokens)
                live.append(rec)
            except IntakeFullError:
                rec.shed = True
            rec.submit = time.perf_counter()

    async def hook(fe) -> None:
        now = rounds.t1[-1]
        depth.append((now, fe.pending))
        for rec in list(live):
            _collect(rec, now)
            if rec.handle.done:
                live.remove(rec)
        if state["open_round"] is None and now > t_open:
            state["open_round"] = len(rounds) - 1
            state["stats_open"] = engine.stats()
        if state["close_round"] is None and now >= t_close:
            state["close_round"] = len(rounds) - 1
            state["stats_close"] = engine.stats()
        if (rounds.trace is None and trace is not None
                and now >= state["trace_at"]):
            rounds.trace = (len(rounds), state["trace_n"])
        # requests that fell due during the round enter before the next
        # one starts: the frontend moves its intake into the engine
        # between rounds, so none is admitted later than at its due time
        if not frontend["stop"].is_set():
            await submit_due(time.perf_counter())

    def waiting() -> bool:
        """Whether a request due in the window still lacks its first
        token (and has not failed)."""
        return any(t_open <= r.due < t_close and not r.shed and not r.times
                   and not (r.handle is not None and r.handle.done)
                   for r in recs)

    async def main() -> None:
        loop = asyncio.get_running_loop()
        loop.set_default_executor(pool)
        fe = AsyncFrontend(engine, intake_limit=intake_limit,
                           round_hook=hook)
        stop = asyncio.Event()
        frontend.update(fe=fe, stop=stop)

        async def submitter():
            # the schedule while no round runs (the hook covers rounds)
            while nxt[0] < len(traffic) and not stop.is_set():
                delay = t0 + float(traffic.due_s[nxt[0]]) - time.perf_counter()
                if delay > 0:
                    try:
                        await asyncio.wait_for(stop.wait(), delay)
                    except asyncio.TimeoutError:
                        pass
                if not stop.is_set():
                    await submit_due(time.perf_counter())

        async with fe:
            task = asyncio.ensure_future(submitter())
            while True:
                await asyncio.sleep(0.02)
                now = time.perf_counter()
                if now >= t_close and state["close_round"] is not None and (
                        not waiting() or now >= t_close + wait_s):
                    break
                if task.done():
                    task.result()
                    if now >= t_close + wait_s:
                        break
            stop.set()
            await task
            for rec in live:
                rec.handle.cancel()
        if rounds.profiler is not None and rounds.profiled == (0, 0):
            await loop.run_in_executor(None, rounds.profiler.stop)
            rounds.profiled = (rounds.trace[0], len(rounds))

    asyncio.run(main())
    del engine.step
    rounds.engine = rounds._step = None
    for rec in recs:                # the handles hold the frontend
        rec.req, rec.handle = rec.engine_req(), None
    run = Run("open", recs, rounds, t_open, t_close, seconds,
              state["stats_open"], state["stats_close"])
    run.lateness = [r.submit - r.due for r in recs]
    run.extra["queue_depth"] = depth
    run.extra["open_round"] = state["open_round"]
    run.extra["close_round"] = state["close_round"]
    return run


def serve_documents(engine, documents) -> None:
    """Serve each document once as a prompt of its own: on retirement
    its pages go into the prefix cache, where the traffic finds them."""
    for doc in documents:
        engine.submit(doc, 1)
    engine.run_until_done()


def warm_shapes(engine, sizes: List[int], prompt_len: int, vocab: int,
                seed: int) -> None:
    """Serve ``n`` throwaway requests of ``prompt_len`` tokens and 2
    output tokens for each ``n`` in ``sizes``: every bucket shape the
    cell dispatches runs once, a prefill chunk round and a decode
    round, before anything is timed."""
    gen = np.random.default_rng([int(seed) & (2 ** 63 - 1), 99])
    for n in sizes:
        for _ in range(n):
            engine.submit(gen.integers(0, vocab, prompt_len).astype(np.int32),
                          2)
        engine.run_until_done()


def bucket_sizes(capacity: int) -> List[int]:
    """Every row count the bucketed dispatch can take: powers of 2
    below ``capacity``, and ``capacity``."""
    out, b = [], 1
    while b < capacity:
        out.append(b)
        b *= 2
    return out + [capacity]


def free_device() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
