"""Real (threading) implementations of the paper's primitives for the host
control plane (a copy of ``repro.core.hostsync`` for the PyTorch port:
the mutexes and semaphores the serving engine runs — the futex mutex and
the host barriers are not ported yet).

A multi-host training deployment needs exactly the operations the paper
builds: barriers (checkpoint quiescence, mesh reconfiguration), mutexes
(membership/metadata mutation), and semaphores (serving admission control).
These are the *measured-on-this-machine* implementations — the "Host" row of
the machine-abstraction classification in EXPERIMENTS.md — and they mirror
the paper's algorithms one-to-one:

  =====================  ==========================================
  paper                  here
  =====================  ==========================================
  atomic (atomicExch /   ``AtomicWord`` — a lock-guarded int. RMW
  atomicInc)             costs a lock round trip (the "atomic").
  volatile load/store    plain Python attribute read/write of an int
                         (GIL-atomic, no lock — the cheap access).
  GPU spinning           busy retry of the RMW
  GPU sleeping           polling a plain int the owner updates
  backoff                incremental ``time.sleep`` between retries
  CPU blocking           ``threading.Condition`` (the futex analogue;
                         exists on hosts, impossible on the GPU)
  =====================  ==========================================

The same asymmetry the paper measures on GPUs (atomics ~3-90x slower than
volatile accesses) holds here (a contended ``threading.Lock`` RMW vs a plain
read), so the paper's designs — bound the atomics, front-load them, then poll
— transfer directly, and the reference's ``benchmarks/hostbench.py``
measures by how much.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from .abstraction import MachineAbstraction, WaitStrategy, select_wait_strategy

# A "volatile-read unit" for backoff sleeps (paper: I * t_volatile_read).
# On this host a plain attribute read is ~50ns; time.sleep granularity makes
# the effective floor ~50us, which plays the same role as the paper's
# DRAM-latency floor on Tesla.
_BACKOFF_UNIT_S = 5e-6


class Backoff:
    """Paper Section 5 backoff: sleep I units, I in [i_min, i_max], wrap."""

    __slots__ = ("i_min", "i_max", "_i")

    def __init__(self, i_min: int = 1, i_max: int = 64):
        self.i_min = i_min
        self.i_max = i_max
        self._i = i_min

    def pause(self) -> None:
        time.sleep(self._i * _BACKOFF_UNIT_S)
        self._i += 1
        if self._i > self.i_max:
            self._i = self.i_min

    def reset(self) -> None:
        self._i = self.i_min


class AtomicWord:
    """A word of shared memory with atomic RMW ops (the paper's substrate).

    ``exch``/``fetch_add`` are the expensive serializing operations;
    ``load``/``store`` are the cheap "volatile" accesses (plain int
    reads/writes are atomic under the GIL, like 4-byte aligned accesses on
    the GPU — torn reads are impossible, coherence is immediate).
    """

    __slots__ = ("_lock", "value")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self.value = value

    def exch(self, new: int) -> int:
        with self._lock:
            old = self.value
            self.value = new
            return old

    def fetch_add(self, delta: int = 1) -> int:
        with self._lock:
            old = self.value
            self.value = old + delta
            return old

    def load(self) -> int:          # volatile load
        return self.value

    def store(self, new: int) -> None:  # volatile store
        self.value = new


def _wait(poll: Callable[[], bool], strategy: WaitStrategy,
          backoff: Optional[Backoff], timeout: Optional[float]) -> bool:
    """Shared wait loop. Returns False on timeout."""
    deadline = None if timeout is None else time.monotonic() + timeout
    bo = backoff or Backoff()
    while not poll():
        if deadline is not None and time.monotonic() > deadline:
            return False
        if strategy is WaitStrategy.SPIN:
            continue
        bo.pause()
    return True


# ---------------------------------------------------------------------------
# Mutexes
# ---------------------------------------------------------------------------

class LockStats:
    """Acquire/contended-acquire/held-time instrumentation, shared by the
    host mutexes.

    ``contended`` means the acquire did not succeed on its first
    serializing access (spin retry needed / turn not yet ours) — the
    paper's signal that the wait strategy matters at all. The last
    ``contention_window`` acquires keep their contended bit in a sliding
    window so contention-adaptive callers can re-select a strategy from
    *measured* recent behavior (``recent_contention``), not lifetime
    averages that stale the signal.

    Counter writes are owner-side (post-acquire / pre-release), so they
    add no synchronizing accesses of their own — exactly the accounting
    discipline the paper uses when counting atomics per operation.
    """

    contention_window = 64

    def _init_stats(self) -> None:
        self.acquires = 0
        self.contended_acquires = 0
        self.held_s = 0.0
        self._recent = collections.deque(maxlen=self.contention_window)
        self._t_acquired = 0.0
        # holder watchdog: a critical section held past the threshold is
        # a liveness fault (a stuck/slow holder starves every waiter —
        # the case the paper's analysis assumes away). The threshold
        # survives reset_stats (it is configuration, not a counter).
        self.watchdog_threshold_s = getattr(self, "watchdog_threshold_s",
                                            None)
        self.watchdog_trips = 0
        self._held_now = False
        self._watchdog_flagged = False

    def _note_acquire(self, contended: bool) -> None:
        self.acquires += 1
        self.contended_acquires += int(contended)
        self._recent.append(int(contended))
        self._t_acquired = time.perf_counter()
        self._held_now = True
        self._watchdog_flagged = False

    def _note_release(self) -> None:
        held = time.perf_counter() - self._t_acquired
        self.held_s += held
        self._held_now = False
        if (self.watchdog_threshold_s is not None
                and held > self.watchdog_threshold_s
                and not self._watchdog_flagged):
            self.watchdog_trips += 1
        self._watchdog_flagged = False

    def set_watchdog(self, threshold_s: Optional[float]) -> None:
        """Arm (or disarm with None) the holder watchdog: any critical
        section held longer than ``threshold_s`` counts one
        ``watchdog_trips`` — at release, or earlier if a waiter polls
        :meth:`watchdog_check` while the holder is stuck."""
        self.watchdog_threshold_s = threshold_s

    def watchdog_check(self) -> bool:
        """Poll form for waiters/monitors: True iff the lock is held
        *right now* past the armed threshold. Counts each over-threshold
        hold once (the release-side check skips an already-flagged
        hold). Reads owner-side timestamps without synchronizing — a
        racy read can only mis-time by one poll interval, never corrupt
        the lock."""
        if self.watchdog_threshold_s is None or not self._held_now:
            return False
        if time.perf_counter() - self._t_acquired <= self.watchdog_threshold_s:
            return False
        if not self._watchdog_flagged:
            self._watchdog_flagged = True
            self.watchdog_trips += 1
        return True

    def recent_contention(self) -> float:
        """Fraction of the last ``contention_window`` acquires that were
        contended — the measured signal for strategy re-selection."""
        if not self._recent:
            return 0.0
        return sum(self._recent) / len(self._recent)

    def reset_stats(self) -> None:
        """Zero the counters (benchmarks reset after their warm phase)."""
        self._init_stats()

    def lock_stats(self) -> dict:
        return {
            "acquires": self.acquires,
            "contended_acquires": self.contended_acquires,
            "held_s": self.held_s,
            "recent_contention": self.recent_contention(),
            "watchdog_trips": self.watchdog_trips,
        }


class SpinMutex(LockStats):
    """Paper Algorithm 1/2: atomicExch spin lock (optional backoff)."""

    def __init__(self, strategy: WaitStrategy = WaitStrategy.SPIN_BACKOFF):
        self._word = AtomicWord(0)
        self._strategy = strategy
        self._init_stats()

    def lock(self, timeout: Optional[float] = None) -> bool:
        bo = Backoff()
        deadline = None if timeout is None else time.monotonic() + timeout
        contended = False
        while True:
            if self._word.exch(1) == 0:
                self._note_acquire(contended)
                return True
            contended = True
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self._strategy is not WaitStrategy.SPIN:
                bo.pause()

    def unlock(self) -> None:
        self._note_release()
        self._word.store(0)  # volatile store, no atomic (Alg. 2)

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class TicketMutex(LockStats):
    """Paper Algorithm 3: fetch-and-add mutex — one atomic to lock, zero to
    unlock, FIFO-fair. The waiting is "GPU sleeping": polling a plain int.
    """

    def __init__(self, strategy: WaitStrategy = WaitStrategy.SLEEP):
        self._ticket = AtomicWord(0)
        self._turn = 0  # written only by the lock owner; read by waiters
        self._strategy = strategy
        self._init_stats()

    def lock(self, timeout: Optional[float] = None) -> bool:
        my = self._ticket.fetch_add(1)
        contended = self._turn != my
        ok = _wait(lambda: self._turn == my, self._strategy,
                   Backoff(1, 8), timeout)
        if not ok:
            # A timed-out waiter must still consume its turn when it comes,
            # or every later ticket deadlocks; simplest safe policy at the
            # control-plane level: block until granted, then release.
            _wait(lambda: self._turn == my, WaitStrategy.SPIN_BACKOFF,
                  Backoff(1, 8), None)
            self._turn = my + 1
            return False
        self._note_acquire(contended)
        return True

    def unlock(self) -> None:
        self._note_release()
        self._turn += 1  # owner-only write; no atomic needed

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


class AdaptiveMutex:
    """Contention-adaptive wrapper: a FIFO ticket mutex whose *wait
    strategy* re-resolves from measured contention (paper Section 6).

    The algorithm never changes — Algorithm 3's one-FA-acquire /
    zero-atomic-release and its FIFO fairness hold at every strategy —
    only how waiters wait does: ``retune()`` reads the inner lock's
    sliding contention window and swaps its strategy via
    ``select_wait_strategy``. Callers retune *between* scheduler rounds
    (the strategy write is a single owner-side attribute store; waiters
    already parked keep the strategy they entered with, new waiters see
    the new one — never a mid-critical-section change of discipline).
    """

    def __init__(self, inner: TicketMutex, machine: MachineAbstraction):
        self.inner = inner
        self.machine = machine
        self.retunes = 0

    @property
    def strategy(self) -> WaitStrategy:
        return self.inner._strategy

    def retune(self, measured_contention: Optional[float] = None
               ) -> WaitStrategy:
        """Re-select the wait strategy from measured contention (default:
        the inner lock's recent window). Returns the strategy now in
        effect."""
        c = (self.inner.recent_contention()
             if measured_contention is None else float(measured_contention))
        new = select_wait_strategy(self.machine, c)
        if new is not self.inner._strategy:
            self.inner._strategy = new
            self.retunes += 1
        return new

    # -- delegation: the wrapper is a drop-in mutex -------------------------
    def lock(self, timeout: Optional[float] = None) -> bool:
        return self.inner.lock(timeout=timeout)

    def unlock(self) -> None:
        self.inner.unlock()

    def recent_contention(self) -> float:
        return self.inner.recent_contention()

    def reset_stats(self) -> None:
        self.inner.reset_stats()

    def set_watchdog(self, threshold_s: Optional[float]) -> None:
        self.inner.set_watchdog(threshold_s)

    def watchdog_check(self) -> bool:
        return self.inner.watchdog_check()

    @property
    def watchdog_trips(self) -> int:
        return self.inner.watchdog_trips

    def lock_stats(self) -> dict:
        st = self.inner.lock_stats()
        st["retunes"] = self.retunes
        st["strategy"] = self.inner._strategy.value
        return st

    # expose the counters the engines read
    @property
    def acquires(self) -> int:
        return self.inner.acquires

    @property
    def contended_acquires(self) -> int:
        return self.inner.contended_acquires

    @property
    def held_s(self) -> float:
        return self.inner.held_s

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
        return False


# ---------------------------------------------------------------------------
# Semaphores
# ---------------------------------------------------------------------------

class SleepingSemaphore:
    """Paper Algorithm 5: count/ticket/turn FA semaphore.

    wait(): 1 atomic under capacity (2 over); post(): 1-2 atomics, never
    waits. FIFO-fair among over-capacity waiters.
    """

    def __init__(self, initial: int,
                 strategy: WaitStrategy = WaitStrategy.SLEEP):
        if initial < 1:
            raise ValueError("semaphore capacity must be >= 1")
        self.capacity = initial
        self._count = AtomicWord(0)
        self._ticket = AtomicWord(0)
        self._turn = AtomicWord(0)  # atomically incremented by posters
        self._strategy = strategy

    def wait(self, timeout: Optional[float] = None) -> bool:
        old = self._count.fetch_add(1)
        if old < self.capacity:
            return True
        my = self._ticket.fetch_add(1)
        ok = _wait(lambda: self._turn.load() > my, self._strategy,
                   Backoff(1, 8), timeout)
        if not ok:
            # Roll back: we never entered. Undo the count and burn our
            # ticket when it arrives (same policy as TicketMutex.lock).
            _wait(lambda: self._turn.load() > my,
                  WaitStrategy.SPIN_BACKOFF, Backoff(1, 8), None)
            self._do_post()
            return False
        return True

    def _do_post(self) -> None:
        old = self._count.fetch_add(-1)
        if old > self.capacity:
            self._turn.fetch_add(1)

    def post(self) -> None:
        self._do_post()

    def __enter__(self):
        self.wait()
        return self

    def __exit__(self, *exc):
        self.post()
        return False


class SpinSemaphore:
    """Paper Algorithm 4: atomicExch spin semaphore (baseline)."""

    def __init__(self, initial: int,
                 strategy: WaitStrategy = WaitStrategy.SPIN_BACKOFF):
        self.capacity = initial
        self._word = AtomicWord(initial + 1)
        self._strategy = strategy

    def wait(self, timeout: Optional[float] = None) -> bool:
        bo = Backoff()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            old = self._word.exch(0)
            if old > 1:
                self._word.exch(old - 1)
                return True
            if old == 1:
                self._word.exch(1)
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self._strategy is not WaitStrategy.SPIN:
                bo.pause()

    def post(self) -> None:
        while True:  # post() is aggressive — no backoff (paper note)
            old = self._word.exch(0)
            if old > 0:
                self._word.exch(old + 1)
                return
