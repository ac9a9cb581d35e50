"""The paper's synchronization algorithms as memsim block programs (a
copy of ``repro.core.primitives_sim`` for the PyTorch port).

Implements, verbatim from Stuart & Owens Algorithms 1-5 plus the Xiao-Feng
barrier (paper Section 5):

  mutexes:    spin (Alg. 1/2), spin+backoff (Alg. 2), fetch-and-add (Alg. 3)
  semaphores: spin (Alg. 4), spin+backoff (Alg. 4), sleeping (Alg. 5)
  barriers:   two-stage centralized atomic, XF decentralized flag barrier

Every program has *block semantics* (the paper's model: one master thread per
block touches the primitive).  Each benchmark block performs ``ops``
iterations of {lock; unlock} / {wait; post} / {barrier} around an empty
critical section, exactly the paper's Section 6 methodology, and the figure
of merit is operations per second of simulated time.

Memory layout (word addresses; distinct lines where the algorithm requires
noncontentious behavior):

  mutex:      word 0 = lock / ticket;  word LINE_WORDS = turn
  semaphore:  word 0 = S (spin) | count; LINE_WORDS = ticket; 2*LINE_WORDS = turn
  barriers:   counters at words 0 / LINE_WORDS; XF flag arrays at FLAGS_BASE
              (one word per block, blocks' flags packed — the XF trick is that
              *writes* are each to the block's own word and only the master
              scans them; packing trades read coalescing exactly like the
              paper describes)

The simulator's correctness checks (critical-section overlap, FIFO fairness,
semaphore occupancy bound) are asserted by instrumenting entry/exit through
``CriticalSectionMonitor`` — these invariants are what the tests lean on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .abstraction import MachineAbstraction, WaitStrategy
from .memsim import LINE_WORDS, BlockProgram, MemSim

# Word addresses (see module docstring).
A_LOCK = 0
A_TURN = LINE_WORDS
A_SEM = 0
A_SEM_TICKET = LINE_WORDS
A_SEM_TURN = 2 * LINE_WORDS
A_BAR_COUNT = 0
A_BAR_GEN = LINE_WORDS
FLAGS_BASE = 8 * LINE_WORDS

@dataclasses.dataclass(frozen=True)
class BackoffConfig:
    """Paper Section 5: sleep I volatile-read units, I in [i_min, i_max]."""

    i_min: int = 1
    i_max: int = 64

    def next_sleep_us(self, i: int, machine: MachineAbstraction) -> float:
        return i * machine.volatile_latency_us(write=False)

    def advance(self, i: int) -> int:
        nxt = i + 1
        return self.i_min if nxt > self.i_max else nxt


# Default backoff windows (in units of a noncontentious volatile read).
# Polling ("sleeping") algorithms overshoot a handoff by ~i_max/2 reads, so
# they want a short window; spin algorithms need a long one to let the
# atomic queue drain. The paper leaves both compile-time configurable.
POLL_BACKOFF = BackoffConfig(i_min=1, i_max=8)
SPIN_BACKOFF = BackoffConfig(i_min=4, i_max=64)


@dataclasses.dataclass
class CriticalSectionMonitor:
    """Asserts mutual exclusion / capacity invariants as the sim runs."""

    capacity: int = 1
    inside: int = 0
    max_inside: int = 0
    entries: List[int] = dataclasses.field(default_factory=list)
    violations: int = 0

    def enter(self, bid: int) -> None:
        self.inside += 1
        self.max_inside = max(self.max_inside, self.inside)
        if self.inside > self.capacity:
            self.violations += 1
        self.entries.append(bid)

    def leave(self, bid: int) -> None:
        self.inside -= 1


# ---------------------------------------------------------------------------
# Mutexes
# ---------------------------------------------------------------------------

def spin_mutex_program(
    ops: int,
    monitor: Optional[CriticalSectionMonitor] = None,
    backoff: Optional[BackoffConfig] = None,
    cs_us: float = 0.0,
):
    """Algorithm 1/2: atomicExch spin lock, optional backoff.

    ``cs_us`` > 0 puts simulated work inside the critical section so the
    monitor can observe (and the tests can assert) mutual exclusion across
    interleavings; benchmarks use the paper's empty critical section.
    """

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        for _ in range(ops):
            i = backoff.i_min if backoff else 0
            while True:
                old = yield ("atomic_exch", A_LOCK, 1)
                if old == 0:
                    break
                if backoff is not None:
                    yield ("sleep", backoff.next_sleep_us(i, sim.machine))
                    i = backoff.advance(i)
            if monitor:
                monitor.enter(bid)
            if cs_us > 0.0:
                yield ("sleep", cs_us)
            if monitor:
                monitor.leave(bid)
            # Alg. 2 unlock: plain (volatile) store of 0.
            yield ("store", A_LOCK, 0)
        return

    return prog


def fa_mutex_program(
    ops: int,
    monitor: Optional[CriticalSectionMonitor] = None,
    backoff: Optional[BackoffConfig] = None,
    cs_us: float = 0.0,
):
    """Algorithm 3: fetch-and-add (ticket) mutex.

    One atomic in lock(), zero in unlock(); waiting is volatile polling of
    the turn word ("GPU sleeping"), optionally spaced by backoff.
    """

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        bo = backoff or POLL_BACKOFF
        for _ in range(ops):
            i = bo.i_min
            ticket = yield ("atomic_add", A_LOCK, 1)
            while True:
                turn = yield ("load", A_TURN)
                if turn == ticket:
                    break
                yield ("sleep", bo.next_sleep_us(i, sim.machine))
                i = bo.advance(i)
            if monitor:
                monitor.enter(bid)
            if cs_us > 0.0:
                yield ("sleep", cs_us)
            if monitor:
                monitor.leave(bid)
            # unlock: volatile read + write, no atomics (we own the lock).
            turn = yield ("load", A_TURN)
            yield ("store", A_TURN, turn + 1)
        return

    return prog


# ---------------------------------------------------------------------------
# Semaphores
# ---------------------------------------------------------------------------

def spin_semaphore_program(
    ops: int,
    initial: int,
    monitor: Optional[CriticalSectionMonitor] = None,
    backoff: Optional[BackoffConfig] = None,
    cs_us: float = 0.0,
):
    """Algorithm 4: atomicExch spin semaphore (S initialized to initial+1).

    S==0: someone holds the word; S==1: at capacity; S>1: S-1 slots free.
    Backoff applies to wait() only — post() stays aggressive (paper note).
    """

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        for _ in range(ops):
            i = (backoff.i_min if backoff else 1)
            # ---- wait()
            acquired = False
            while not acquired:
                old = yield ("atomic_exch", A_SEM, 0)
                if old > 1:
                    yield ("atomic_exch", A_SEM, old - 1)
                    acquired = True
                elif old == 1:
                    yield ("atomic_exch", A_SEM, 1)
                if not acquired and backoff is not None:
                    yield ("sleep", backoff.next_sleep_us(i, sim.machine))
                    i = backoff.advance(i)
            if monitor:
                monitor.enter(bid)
            if cs_us > 0.0:
                yield ("sleep", cs_us)
            if monitor:
                monitor.leave(bid)
            # ---- post()  (no backoff)
            posted = False
            while not posted:
                old = yield ("atomic_exch", A_SEM, 0)
                if old > 0:
                    yield ("atomic_exch", A_SEM, old + 1)
                    posted = True
        return

    return prog


def sleeping_semaphore_program(
    ops: int,
    initial: int,
    monitor: Optional[CriticalSectionMonitor] = None,
    backoff: Optional[BackoffConfig] = None,
    cs_us: float = 0.0,
):
    """Algorithm 5: FA-style sleeping semaphore (count/ticket/turn).

    wait(): one atomicInc; if over capacity, one more atomicInc for a ticket,
    then volatile-poll the turn word. post(): one atomicDec, plus one
    atomicInc of turn only if someone is waiting. Fair; <=2 atomics per op.
    """

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        bo = backoff or POLL_BACKOFF
        for _ in range(ops):
            i = bo.i_min
            # ---- wait()
            old = yield ("atomic_add", A_SEM, 1)
            if old >= initial:
                ticket = yield ("atomic_add", A_SEM_TICKET, 1)
                while True:
                    turn = yield ("load", A_SEM_TURN)
                    if turn > ticket:
                        break
                    yield ("sleep", bo.next_sleep_us(i, sim.machine))
                    i = bo.advance(i)
            if monitor:
                monitor.enter(bid)
            if cs_us > 0.0:
                yield ("sleep", cs_us)
            if monitor:
                monitor.leave(bid)
            # ---- post()
            old = yield ("atomic_add", A_SEM, -1)
            if old > initial:
                yield ("atomic_add", A_SEM_TURN, 1)
        return

    return prog


# ---------------------------------------------------------------------------
# Barriers
# ---------------------------------------------------------------------------

def atomic_barrier_program(ops: int, nblocks: int):
    """Two-stage centralized atomic counter barrier (the XF paper's baseline).

    Arrive: fetch-and-add a shared counter (contentious atomic). The last
    arriver resets the counter and bumps the generation; everyone else
    volatile-polls the generation word.
    """

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        for _ in range(ops):
            gen = yield ("load", A_BAR_GEN)
            old = yield ("atomic_add", A_BAR_COUNT, 1)
            if old == nblocks - 1:
                yield ("store", A_BAR_COUNT, 0)
                yield ("store", A_BAR_GEN, gen + 1)
            else:
                while True:
                    g = yield ("load", A_BAR_GEN)
                    if g != gen:
                        break
        return

    return prog


def xf_barrier_program(ops: int, nblocks: int):
    """Xiao-Feng decentralized flag barrier (paper Section 5, no atomics).

    Epoch-numbered flags avoid re-zeroing between barriers. Block i writes
    arrive[i] = epoch (its own word — noncontentious write); the master block
    warp-scans the arrive array, then warp-broadcasts release[i] = epoch;
    non-master blocks volatile-poll their own release word.
    """
    arrive = FLAGS_BASE
    release = FLAGS_BASE + ((nblocks + LINE_WORDS) // LINE_WORDS + 1) * LINE_WORDS

    def prog(sim: MemSim, bid: int) -> BlockProgram:
        for epoch in range(1, ops + 1):
            yield ("store", arrive + bid, epoch)
            if bid == 0:
                while True:
                    ok = yield ("scan_flags", arrive, nblocks, epoch)
                    if ok:
                        break
                yield ("broadcast_store", release, nblocks, epoch)
            else:
                while True:
                    v = yield ("load", release + bid)
                    if v == epoch:
                        break
        return

    return prog


# ---------------------------------------------------------------------------
# Benchmark runner
# ---------------------------------------------------------------------------

MUTEX_IMPLS = ("spin", "spin_backoff", "fa", "fa_backoff")
SEMAPHORE_IMPLS = ("spin", "spin_backoff", "sleeping")
BARRIER_IMPLS = ("atomic", "xf")


@dataclasses.dataclass
class PrimitiveResult:
    machine: str
    primitive: str
    impl: str
    blocks: int
    ops_per_block: int
    sim_time_us: float
    ops_per_sec: float
    atomic_ops: int
    volatile_ops: int
    hostage_conversions: int
    fair_fifo: bool
    violations: int
    # True when the run hit the event budget before completing (the paper's
    # own curves truncate the Tesla spin semaphore/mutex for the same
    # reason); ops_per_sec is then the rate over the simulated prefix.
    truncated: bool = False


def run_primitive(
    machine: MachineAbstraction,
    primitive: str,
    impl: str,
    *,
    blocks: int,
    ops: int = 100,
    initial: int = 1,
    backoff: Optional[BackoffConfig] = None,
    cs_us: float = 0.0,
    max_events: int = 20_000_000,
) -> PrimitiveResult:
    """Simulate ``blocks`` blocks each doing ``ops`` primitive operations."""
    sim = MemSim(machine)
    monitor = CriticalSectionMonitor(capacity=initial if primitive == "semaphore" else 1)

    if primitive == "mutex":
        if impl == "spin":
            prog = spin_mutex_program(ops, monitor, cs_us=cs_us)
        elif impl == "spin_backoff":
            prog = spin_mutex_program(ops, monitor, backoff or SPIN_BACKOFF, cs_us=cs_us)
        elif impl == "fa":
            prog = fa_mutex_program(ops, monitor, cs_us=cs_us)
        elif impl == "fa_backoff":
            prog = fa_mutex_program(ops, monitor, backoff or POLL_BACKOFF, cs_us=cs_us)
        else:
            raise ValueError(impl)
        sim.poke(A_TURN, 0)
    elif primitive == "semaphore":
        if impl == "spin":
            prog = spin_semaphore_program(ops, initial, monitor, cs_us=cs_us)
            sim.poke(A_SEM, initial + 1)
        elif impl == "spin_backoff":
            prog = spin_semaphore_program(ops, initial, monitor, backoff or SPIN_BACKOFF, cs_us=cs_us)
            sim.poke(A_SEM, initial + 1)
        elif impl == "sleeping":
            prog = sleeping_semaphore_program(ops, initial, monitor, cs_us=cs_us)
        else:
            raise ValueError(impl)
    elif primitive == "barrier":
        if impl == "atomic":
            prog = atomic_barrier_program(ops, blocks)
        elif impl == "xf":
            prog = xf_barrier_program(ops, blocks)
        else:
            raise ValueError(impl)
    else:
        raise ValueError(primitive)

    truncated = False
    try:
        us = sim.run([prog] * blocks, max_events=max_events)
        total_ops = ops if primitive == "barrier" else ops * blocks
    except RuntimeError:
        # Event budget exhausted — the pathological regime the paper also
        # truncates (Tesla spin semaphore/mutex at scale). Report the rate
        # over the completed prefix.
        truncated = True
        us = sim.now
        total_ops = max(1, len(monitor.entries))
        if primitive == "barrier":
            total_ops = max(1, total_ops // max(blocks, 1))
    # Ops/sec figure of merit, per paper Section 6: barriers — all blocks
    # complete one barrier per op; mutex/semaphore — one lock/unlock per op
    # per block, total = blocks * ops.
    fair = _is_fifo_fair(monitor.entries, blocks) if primitive == "mutex" and impl.startswith("fa") else True
    return PrimitiveResult(
        machine=machine.name,
        primitive=primitive,
        impl=impl,
        blocks=blocks,
        ops_per_block=ops,
        sim_time_us=us,
        ops_per_sec=total_ops / (us * 1e-6) if us > 0 else float("inf"),
        atomic_ops=sim.stats.atomic_ops,
        volatile_ops=sim.stats.volatile_loads + sim.stats.volatile_stores,
        hostage_conversions=sim.stats.hostage_conversions,
        fair_fifo=fair,
        violations=monitor.violations,
        truncated=truncated,
    )


def _is_fifo_fair(entries: List[int], blocks: int) -> bool:
    """FA mutex grants in ticket order => first `blocks` entries are distinct.

    (All blocks take their first ticket before any re-locks, so a FIFO-fair
    mutex must admit every block once before any block's second entry.)
    """
    if len(entries) < blocks:
        return True
    first_round: Dict[int, int] = {}
    for pos, bid in enumerate(entries):
        if bid not in first_round:
            first_round[bid] = pos
        if len(first_round) == blocks:
            break
    # every block's first entry happened before position `blocks` + slack
    return all(pos < blocks * 2 for pos in first_round.values())
