"""Discrete-event simulator of the paper's GPU memory-system abstraction
(a copy of ``repro.core.memsim`` for the PyTorch port: plain Python, the
event order, the jitter sequence and every constant as the reference has
them, so each simulated time equals the reference's exactly).

Stuart & Owens derive their primitive designs from how a GPU memory system
services *atomic* vs *volatile* accesses under contention (paper Sections 3-4).
No 2011 GPU is at hand, so we reproduce their published
behavior with a small event-driven simulator whose cost model is exactly the
paper's machine abstraction:

  * every memory **line** is a FIFO server: accesses to the same line
    serialize with a per-access *service* time (throughput limit), then the
    issuing block observes an additional *latency* before it resumes;
  * **atomics** have their own (much larger) service time — the "atomic unit";
  * **line hostage** (P3, Fermi): while a line's atomic queue is non-empty,
    volatile accesses to that line are serviced *as if they were atomics*
    ("essentially treating them as an atomicAdd(memory, 0)", paper Section 3);
  * **noncontentious** accesses (each block its own line) never queue, so they
    cost only the latency — which is how the simulator reproduces the paper's
    contentious:noncontentious ratios without them being hard-coded.

Service/latency constants are derived from paper Table 1 via
``MachineAbstraction`` (see ``abstraction.py``), and the simulator re-runs the
paper's twelve benchmarks as a self-consistency check
(``repro_torch.benchmarks.membench``).

Blocks are Python generators that ``yield`` memory operations; the engine
resumes them with the result at the operation's completion time.  Supported
operations (all block-semantics, one master thread per block, as in the
paper):

  ("atomic_exch", addr, val)         -> old value        (atomicExch)
  ("atomic_add",  addr, delta)       -> old value        (fetch-and-add)
  ("load",  addr)                    -> value            (volatile load)
  ("store", addr, val)               -> None             (volatile store)
  ("scan_flags", base, n, want)      -> bool             (warp-parallel check:
        one thread per flag word; costs ceil(n/threads) noncontentious loads)
  ("broadcast_store", base, n, val)  -> None             (warp-parallel store)
  ("sleep", duration_us)             -> None             (GPU backoff sleep)

Addresses are integers; ``line_of`` maps an address to a line (4-byte words,
LINE_WORDS words per line). The XF-style noncontentious layouts place each
block's word on its own line, like the paper's 256-byte-separated benchmark
buffers.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, Generator, Iterable, List, Optional, Tuple

from .abstraction import MachineAbstraction

# Four-byte words; paper GPUs have 128-byte lines = 32 words. Noncontentious
# buffers in the paper are 256-byte separated, i.e. never share a line.
LINE_WORDS = 32

Op = Tuple  # ("opname", *args)
BlockProgram = Generator[Op, object, None]


def line_of(addr: int) -> int:
    return addr // LINE_WORDS


@dataclasses.dataclass
class _LineState:
    free_at: float = 0.0           # FIFO server: time the line is next free
    atomic_busy_until: float = 0.0  # last pending atomic drains at this time


@dataclasses.dataclass
class SimStats:
    """Aggregate counters, reported alongside simulated time."""

    atomic_ops: int = 0
    volatile_loads: int = 0
    volatile_stores: int = 0
    hostage_conversions: int = 0  # volatiles serviced as atomics (P3)
    sleeps: int = 0
    sim_events: int = 0


class MemSim:
    """Event-driven simulator for one kernel launch of B blocks."""

    def __init__(
        self,
        machine: MachineAbstraction,
        warp_width: int = 128,
        jitter: float = 0.02,
    ):
        self.machine = machine
        self.warp_width = warp_width  # threads per block for scan/broadcast ops
        # Deterministic per-event latency jitter (fraction of the op's
        # duration). Real GPUs have scheduling variance; without it, a
        # lockstep simulation can livelock spin algorithms on value-parity
        # (e.g. the spin semaphore's grab/restore alternation can
        # systematically exclude posters — the paper's "unpredictable and
        # poor" regime). 2% breaks lockstep without moving the aggregates.
        self.jitter = jitter
        self.mem: Dict[int, int] = {}
        self.lines: Dict[int, _LineState] = {}
        self.stats = SimStats()
        self.now = 0.0
        self._heap: List[Tuple[float, int, int]] = []  # (time, seq, block)
        self._seq = 0
        self._rng_state = 0x9E3779B97F4A7C15

    # ------------------------------------------------------------------ mem
    def peek(self, addr: int) -> int:
        return self.mem.get(addr, 0)

    def poke(self, addr: int, val: int) -> None:
        self.mem[addr] = val

    def _line(self, addr: int) -> _LineState:
        lid = line_of(addr)
        st = self.lines.get(lid)
        if st is None:
            st = self.lines[lid] = _LineState()
        return st

    # ------------------------------------------------------------- services
    def _service(self, addr: int, t: float, *, atomic: bool, write: bool) -> float:
        """Queue one access on the line's FIFO server; return completion time.

        The line is *occupied* for the service time (throughput limit); the
        issuing block resumes after the access *latency* (round trip). The
        latency is not added on top of the service time — a pipelined memory
        system overlaps them — which is what makes the simulator reproduce
        both Table-1 noncontentious latencies and contentious throughputs
        from the same two constants.
        """
        m = self.machine
        ln = self._line(addr)
        start = max(t, ln.free_at)
        if atomic:
            svc = m.atomic_service_us(write)
            lat = m.atomic_latency_us(write)
            if math.isinf(svc):
                raise RuntimeError(
                    f"machine {m.name!r} has no atomics; algorithm is invalid "
                    "for this machine class"
                )
            ln.atomic_busy_until = start + svc
            self.stats.atomic_ops += 1
        else:
            # P3 check uses the *arrival* time: does the atomic unit have a
            # non-empty queue when this volatile access reaches the line?
            hostage = m.line_hostage and ln.atomic_busy_until > t
            if hostage:
                # The atomic unit owns this line; the volatile access is
                # serialized through the atomic queue at atomic cost
                # ("essentially treating them as an atomicAdd(memory, 0)").
                svc = m.atomic_service_us(write)
                lat = m.atomic_latency_us(write)
                ln.atomic_busy_until = start + svc
                self.stats.hostage_conversions += 1
            else:
                svc = m.volatile_contended_service_us(write)
                lat = m.volatile_latency_us(write)
        ln.free_at = start + svc
        return start + lat

    # ------------------------------------------------------------------ ops
    def _execute(self, op: Op, t: float):
        """Apply ``op`` at time t. Returns (completion_time, result)."""
        kind = op[0]
        if kind == "atomic_exch":
            _, addr, val = op
            done = self._service(addr, t, atomic=True, write=True)
            old = self.peek(addr)
            self.poke(addr, val)
            return done, old
        if kind == "atomic_add":
            _, addr, delta = op
            done = self._service(addr, t, atomic=True, write=True)
            old = self.peek(addr)
            self.poke(addr, old + delta)
            return done, old
        if kind == "load":
            _, addr = op
            done = self._service(addr, t, atomic=False, write=False)
            self.stats.volatile_loads += 1
            return done, self.peek(addr)
        if kind == "store":
            _, addr, val = op
            done = self._service(addr, t, atomic=False, write=True)
            self.stats.volatile_stores += 1
            self.poke(addr, val)
            return done, None
        if kind == "scan_flags":
            _, base, n, want = op
            # Warp-parallel: threads check distinct words concurrently. Each
            # round of `warp_width` loads overlaps; rounds serialize.
            rounds = max(1, -(-n // self.warp_width))
            done = t
            for _ in range(rounds):
                done = self._service(base, done, atomic=False, write=False)
            self.stats.volatile_loads += n
            ok = all(self.peek(base + i) == want for i in range(n))
            return done, ok
        if kind == "broadcast_store":
            _, base, n, val = op
            rounds = max(1, -(-n // self.warp_width))
            done = t
            for _ in range(rounds):
                done = self._service(base, done, atomic=False, write=True)
            self.stats.volatile_stores += n
            for i in range(n):
                self.poke(base + i, val)
            return done, None
        if kind == "sleep":
            _, dur = op
            self.stats.sleeps += 1
            return t + float(dur), None
        raise ValueError(f"unknown op {kind!r}")

    # ------------------------------------------------------------------ run
    def run(
        self,
        programs: Iterable[Callable[["MemSim", int], BlockProgram]],
        max_events: int = 50_000_000,
    ) -> float:
        """Run every block program to completion; return simulated time (us).

        ``programs[i]`` is called as ``program(sim, block_id)`` and must return
        a generator that yields Ops.
        """
        gens: Dict[int, BlockProgram] = {}
        results: Dict[int, object] = {}
        for bid, prog in enumerate(programs):
            gens[bid] = prog(self, bid)
            self._push(0.0, bid)
        end = 0.0
        events = 0
        while self._heap:
            events += 1
            if events > max_events:
                raise RuntimeError("memsim event budget exceeded (deadlock?)")
            t, _, bid = heapq.heappop(self._heap)
            self.now = t
            gen = gens.get(bid)
            if gen is None:
                continue
            try:
                op = gen.send(results.pop(bid, None))
            except StopIteration:
                del gens[bid]
                end = max(end, t)
                continue
            done, res = self._execute(op, t)
            if self.jitter > 0.0 and done > t:
                done = t + (done - t) * (1.0 + self.jitter * self._rand01(bid))
            results[bid] = res
            self._push(done, bid)
        self.stats.sim_events = events
        return end

    def _push(self, t: float, bid: int) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, bid))

    def _rand01(self, salt: int) -> float:
        """Deterministic xorshift in [0, 1) — reproducible across runs."""
        x = (self._rng_state ^ (salt * 0x2545F4914F6CDD1D)) & 0xFFFFFFFFFFFFFFFF
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self._rng_state = x
        return (x >> 11) / float(1 << 53)


# --------------------------------------------------------------------------
# The paper's twelve memory benchmarks (Section 3), as block programs.
# Each master thread performs ``accesses`` operations of one type.
# Layout: contentious -> everyone hits word 0; noncontentious -> block i hits
# word i * LINE_WORDS * 2 (its own line, 256-byte separated like the paper).
# --------------------------------------------------------------------------

def membench_program(
    *,
    atomic: bool,
    contentious: bool,
    write: bool,
    preceded_by_atomic: bool = False,
    accesses: int = 1000,
):
    def prog(sim: MemSim, bid: int) -> BlockProgram:
        addr = 0 if contentious else (bid + 1) * LINE_WORDS * 2
        if preceded_by_atomic:
            yield ("atomic_add", addr, 0)
        for _ in range(accesses):
            if atomic:
                if write:
                    yield ("atomic_exch", addr, 0)
                else:
                    yield ("atomic_add", addr, 0)
            else:
                if write:
                    yield ("store", addr, 1)
                else:
                    yield ("load", addr)
        return

    return prog


def run_membench(
    machine: MachineAbstraction,
    *,
    blocks: Optional[int] = None,
    accesses: int = 1000,
    atomic: bool,
    contentious: bool,
    write: bool,
    preceded_by_atomic: bool = False,
) -> float:
    """Simulated total time (ms) for one Table-1 cell."""
    nb = blocks or machine.saturated_blocks
    sim = MemSim(machine)
    prog = membench_program(
        atomic=atomic,
        contentious=contentious,
        write=write,
        preceded_by_atomic=preceded_by_atomic,
        accesses=accesses,
    )
    us = sim.run([prog] * nb)
    # Scale to the paper's 1000-access convention for direct comparison.
    return us / 1e3 * (1000.0 / accesses)
