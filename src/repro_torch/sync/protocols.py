"""Uniform primitive protocols and the plan types (counterpart of
``repro.sync.protocols``).

Every primitive is usable two ways: as a live object on the host
control plane (``lock()/unlock()``, ``wait()/post()``,
``arrive_and_wait()``) and as a deterministic plan — FIFO fairness
makes the Algorithm-3/5 and XF timelines functions of the trace, which
is what lets the serving scheduler use the semaphore as an admission
*planner*. The ``*Plan`` dataclasses are the result currency across
backends: two backends agree on a trace iff their plans' grant orders,
release timelines and straggler sets match.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Mutex(Protocol):
    def lock(self, timeout: Optional[float] = None) -> bool: ...
    def unlock(self) -> None: ...


@runtime_checkable
class Semaphore(Protocol):
    def wait(self, timeout: Optional[float] = None) -> bool: ...
    def post(self) -> None: ...


@runtime_checkable
class Barrier(Protocol):
    def arrive_and_wait(self, rank: int,
                        timeout: Optional[float] = None) -> bool: ...


@dataclasses.dataclass
class SemaphorePlan:
    """Algorithm-5 admission timeline for a FIFO request trace.

    ``order`` is only set by backends that *observe* grant order (the host
    backend running real threads); computed backends derive it from the
    grant times. ``grant_order`` is therefore comparable across backends.
    """

    arrivals: np.ndarray   # [N] request arrival times
    grant: np.ndarray      # [N] grant times
    release: np.ndarray    # [N] release times (grant + hold)
    waited: np.ndarray     # [N] 1 if the request queued (took a ticket)
    capacity: int
    backend: str = ""
    order: Optional[np.ndarray] = None  # [N] request ids in observed grant order

    @property
    def grant_order(self) -> np.ndarray:
        """Request indices in the order they were granted."""
        if self.order is not None:
            return np.asarray(self.order)
        return np.argsort(self.grant, kind="stable")

    @property
    def wait_times(self) -> np.ndarray:
        return self.grant - self.arrivals

    @property
    def p50_wait(self) -> float:
        return float(np.median(self.wait_times))

    @property
    def p99_wait(self) -> float:
        return float(np.percentile(self.wait_times, 99))

    @property
    def makespan(self) -> float:
        return float(np.max(self.release) - np.min(self.arrivals))


@dataclasses.dataclass
class MutexPlan:
    """FIFO ticket-mutex timeline for a trace of lock requests."""

    arrival: np.ndarray      # [N] requester ids in arrival order
    grant_order: np.ndarray  # [N] requester id holding the lock t-th (== FIFO)
    turn_trace: np.ndarray   # [N] turn observed at acquisition (== ticket)
    acc: float               # order-sensitive affine chain (serialization witness)
    backend: str = ""

    @property
    def fifo(self) -> bool:
        return bool(np.array_equal(self.grant_order, self.arrival))


@dataclasses.dataclass
class BoundedMutexPlan:
    """FIFO ticket-mutex timeline where every requester carries a wait
    *budget* — the plan form of ``lock(timeout=)``.

    A requester whose turn arrives after its budget expires *burns its
    ticket*: it is never granted, holds for zero time, and passes the
    turn on (the live ``TicketMutex`` timeout discipline). Because a
    burned ticket shortens every later wait, the timeline is the fixed
    point of replanning with burned holds zeroed; backends reach the
    same fixed point, so ``granted`` is the cross-backend equivalence
    object.
    """

    arrivals: np.ndarray   # [N] request arrival times
    holds: np.ndarray      # [N] critical-section lengths as requested
    timeouts: np.ndarray   # [N] wait budgets (np.inf = unbounded)
    grant: np.ndarray      # [N] turn times (granted or burned at this time)
    release: np.ndarray    # [N] grant + hold (granted) or grant (burned)
    granted: np.ndarray    # [N] bool: True = acquired, False = timed out
    backend: str = ""
    iterations: int = 1    # replans until the burned set stabilized

    @property
    def timed_out(self) -> np.ndarray:
        return np.flatnonzero(~np.asarray(self.granted))

    @property
    def wait_times(self) -> np.ndarray:
        return self.grant - self.arrivals


@dataclasses.dataclass
class BarrierPlan:
    """One XF-barrier epoch over flag words.

    ``release`` semantics on *non-required* slots are backend-specific
    (the kernel broadcasts only to required slots, the host barrier to all
    parties); cross-backend comparisons use ``released`` which restricts
    to required slots.
    """

    epoch: int
    arrive: np.ndarray       # [N] updated arrive flags
    release: np.ndarray      # [N] release flags
    done: int                # 1 iff all required slots arrived
    stragglers: np.ndarray   # [N] 1 for required slots that never arrived
    required: np.ndarray     # [N] the membership mask the master checked
    backend: str = ""

    @property
    def straggler_ranks(self) -> np.ndarray:
        return np.flatnonzero(np.asarray(self.stragglers))

    @property
    def released(self) -> np.ndarray:
        """Release flags restricted to required slots (backend-comparable)."""
        req = np.asarray(self.required) > 0
        return np.where(req, np.asarray(self.release), 0)
