"""Backend-unified synchronization library (counterpart of
``repro.sync.library``, the serving path's part of it).

The machine abstraction picks an *(backend, algorithm, wait-strategy)*
triple and every axis can be pinned:

    lib = SyncLibrary.host_default()           # nominal host abstraction
    lib = SyncLibrary.for_host()               # probed (cached per process)
    m = lib.mutex(kind="ticket")               # live Algorithm-3 mutex
    s = lib.semaphore(8)                       # live Algorithm-5 semaphore
    b = lib.barrier(4)                         # live XF barrier
    plan = lib.plan_semaphore(arrivals, holds, capacity=8)
    mplan = lib.plan_mutex(arrival_perm, backend="cuda")
    bplan = SyncLibrary(machine=FERMI).plan_barrier(present)  # on cuda
    planner = lib.semaphore_planner(8, window=64, device="cuda")
    SyncLibrary.acquire(m, timeout=0.5)        # SyncTimeoutError on expiry

Live objects run on the host; plans run on the ``cuda`` kernels, their
plain versions (``ref``), or as observed executions of the live
primitives on real threads (``host``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.abstraction import (
    BenchTimes,
    ImplChoice,
    MachineAbstraction,
    PrimitiveKind,
    WaitStrategy,
    classify,
    select_backend,
    select_impl,
)

from repro_torch.core.device import resolve_device

from .backends import SyncBackend, get_backend, make_backends
from .protocols import (
    BarrierPlan,
    BoundedMutexPlan,
    MutexPlan,
    SemaphorePlan,
)

class SyncTimeoutError(TimeoutError):
    """A bounded acquire exhausted its wait budget.

    Raised by :meth:`SyncLibrary.acquire` when the primitive's boolean
    ``timeout=`` form returns False. The primitive is *not* held: every
    host implementation leaves itself consistent on timeout (the ticket
    mutex burns its ticket, the sleeping semaphore rolls its count
    back), so the caller may retry, back off, or fail the enclosing
    operation without any cleanup."""

    def __init__(self, primitive: object, timeout_s: Optional[float],
                 what: str = ""):
        self.primitive = primitive
        self.timeout_s = timeout_s
        name = type(primitive).__name__
        super().__init__(
            f"{what or name}: not acquired within "
            f"{timeout_s if timeout_s is not None else 'inf'}s "
            f"({name})")


def _bounded_acquire(prim, timeout: Optional[float]) -> bool:
    """One bounded acquire on any live primitive: mutexes expose
    ``lock(timeout=)``, semaphores ``wait(timeout=)`` — both return
    False on expiry and leave the primitive consistent."""
    if hasattr(prim, "lock"):
        return bool(prim.lock(timeout=timeout))
    if hasattr(prim, "wait"):
        return bool(prim.wait(timeout=timeout))
    raise TypeError(f"{type(prim).__name__} has no bounded acquire form "
                    "(expected .lock or .wait)")


# A nominal host abstraction for when probing is not worth it (serving
# constructors). Classifies as "balanced": fa mutex, sleeping semaphore.
HOST_NOMINAL = MachineAbstraction(
    name="host-nominal",
    reads=BenchTimes(1.0, 0.5, 5.0, 2.5, 1.2, 0.6),
    writes=BenchTimes(1.0, 0.5, 5.0, 2.5, 1.2, 0.6),
    saturated_blocks=8,
)

# Per-process cache of the measured host abstraction (the probe runs the
# 12-benchmark grid with real threads — far too slow to repeat per call).
# Keyed by the probe parameters so a call with different measurement
# settings never silently gets an abstraction measured with other ones.
_HOST_MACHINES: dict = {}


def classified_host(refresh: bool = False, **probe_kw) -> MachineAbstraction:
    """The measured abstraction of this host, probed once per process
    (per distinct probe parameters).

    ``refresh=True`` re-runs the measurement (e.g. after CPU contention
    changes); ``probe_kw`` forwards to ``hostbench_probe.classify_host``.
    """
    key = tuple(sorted(probe_kw.items()))
    if refresh or key not in _HOST_MACHINES:
        from repro_torch.core.hostbench_probe import classify_host
        _HOST_MACHINES[key] = classify_host(**probe_kw)
    return _HOST_MACHINES[key]


@dataclasses.dataclass
class SyncLibrary:
    """Primitive factory + planner over one machine abstraction.
    ``backend`` / ``*_kind`` / ``strategy`` pin the selection triple's
    axes; ``None`` lets ``select_impl`` decide from the machine."""

    machine: MachineAbstraction
    backend: Optional[str] = None
    mutex_kind: Optional[str] = None
    semaphore_kind: Optional[str] = None
    barrier_kind: Optional[str] = None
    strategy: Optional[WaitStrategy] = None
    _backends: Dict[str, SyncBackend] = dataclasses.field(
        default_factory=make_backends, init=False, repr=False)

    @classmethod
    def for_host(cls, refresh: bool = False, **probe_kw) -> "SyncLibrary":
        """Classify this host (measured, cached per process) and build a
        library on it. ``refresh=True`` forces a re-probe. The machine is
        named ``host-cpu``, so live objects run on the ``host`` backend
        and hot-loop plans go to ``planning_backend_name(device)``."""
        return cls(machine=classified_host(refresh=refresh, **probe_kw))

    @classmethod
    def host_default(cls, **pins) -> "SyncLibrary":
        """Probe-free library on the nominal host abstraction."""
        return cls(machine=HOST_NOMINAL, **pins)

    # ------------------------------------------------------------- selection
    def choice(self, primitive: PrimitiveKind, **kw) -> ImplChoice:
        return select_impl(self.machine, primitive, backend=self.backend,
                           **kw)

    def machine_class(self) -> str:
        return classify(self.machine)

    def backend_name(self) -> str:
        return self.backend or select_backend(self.machine)

    def _backend(self, name: Optional[str] = None) -> SyncBackend:
        """This library's own ``host``/``cuda``/``ref`` backend, else the
        one registered under ``name`` (``KeyError`` when none is)."""
        name = name or self.backend_name()
        if name in self._backends:
            return self._backends[name]
        return get_backend(name)

    def planning_backend_name(self, device=None) -> str:
        """Backend for hot-loop planning: the pinned/selected backend if
        it plans cheaply, else the planner of ``device`` — the CUDA
        kernel on ``cuda`` (the default, which raises without a card),
        its plain version only when the caller asks for ``cpu``."""
        name = self.backend_name()
        if self._backend(name).fast_plans:
            return name
        return "cuda" if resolve_device(device).type == "cuda" else "ref"

    # ------------------------------------------------------------- live form
    def mutex(self, kind: Optional[str] = None, *,
              expected_contention: float = 1.0,
              strategy: Optional[WaitStrategy] = None):
        """Live mutex. ``kind="adaptive"`` gives a FIFO ticket mutex
        whose wait strategy re-selects from its measured contention at
        each ``retune()`` (between scheduler rounds). ``strategy`` pins
        this one mutex's wait strategy; the library's pin still wins."""
        c = self.choice(PrimitiveKind.MUTEX,
                        expected_contention=expected_contention)
        kind = kind or self.mutex_kind or c.algorithm
        strat = self.strategy or strategy or c.strategy
        if kind == "adaptive":
            from repro_torch.core.hostsync import AdaptiveMutex
            return AdaptiveMutex(self._backend().mutex("ticket", strat),
                                 self.machine)
        return self._backend().mutex(kind, strat)

    def semaphore(self, initial: int, kind: Optional[str] = None):
        c = self.choice(PrimitiveKind.SEMAPHORE, semaphore_initial=initial)
        kind = kind or self.semaphore_kind or c.algorithm
        return self._backend().semaphore(initial, kind,
                                         self.strategy or c.strategy)

    def barrier(self, parties: int, kind: Optional[str] = None):
        c = self.choice(PrimitiveKind.BARRIER)
        kind = kind or self.barrier_kind or c.algorithm
        return self._backend().barrier(parties, kind,
                                       self.strategy or c.strategy)

    # --------------------------------------------------------- bounded waits
    @staticmethod
    def acquire(prim, timeout: Optional[float] = None,
                what: str = "") -> None:
        """Acquire a live mutex or semaphore, raising
        :class:`SyncTimeoutError` if ``timeout`` (seconds) expires — the
        exception-typed form of the primitives' boolean ``timeout=``
        protocol. ``timeout=None`` waits unboundedly (never raises)."""
        if not _bounded_acquire(prim, timeout):
            raise SyncTimeoutError(prim, timeout, what)

    @staticmethod
    def try_acquire(prim) -> bool:
        """A zero-budget bounded acquire: True iff the primitive was
        taken at once. The FIFO ticket mutex still burns its ticket on
        failure (it waits for its turn so later tickets never deadlock):
        bounded by one holder's critical section, not O(1)."""
        return _bounded_acquire(prim, 0.0)

    # ------------------------------------------------------------- plan form
    def plan_semaphore(self, arrivals, holds, capacity: int, *,
                       backend: Optional[str] = None,
                       window: Optional[int] = None) -> SemaphorePlan:
        """Deterministic Algorithm-5 timeline for a FIFO request trace.
        Arrivals need not be sorted; the plan comes back in the caller's
        order."""
        arrivals = np.asarray(arrivals, np.float32)
        holds = np.asarray(holds, np.float32)
        perm = np.argsort(arrivals, kind="stable")
        bk = self._backend(backend)
        g, r, w, order = bk.plan_semaphore(arrivals[perm], holds[perm],
                                           capacity, window=window)
        inv = np.argsort(perm, kind="stable")
        return SemaphorePlan(
            arrivals=arrivals, grant=np.asarray(g)[inv],
            release=np.asarray(r)[inv], waited=np.asarray(w)[inv],
            capacity=capacity, backend=bk.name,
            order=None if order is None else perm[np.asarray(order)])

    def plan_mutex(self, arrival, m=None, b=None, *,
                   backend: Optional[str] = None,
                   window: Optional[int] = None) -> MutexPlan:
        """FIFO ticket-mutex timeline for requesters in ``arrival`` order
        (a permutation of 0..N-1). ``m``/``b`` parameterize the
        order-sensitive critical-section chain (default: identity)."""
        arrival = np.asarray(arrival, np.int64)
        n = arrival.shape[0]
        m = np.ones(n, np.float32) if m is None else np.asarray(m, np.float32)
        b = np.zeros(n, np.float32) if b is None else np.asarray(b, np.float32)
        bk = self._backend(backend)
        g, t, acc = bk.plan_mutex(arrival, m, b, window=window)
        return MutexPlan(arrival=arrival, grant_order=np.asarray(g),
                         turn_trace=np.asarray(t), acc=float(acc),
                         backend=bk.name)

    def plan_mutex_bounded(self, arrivals, holds, timeouts, *,
                           backend: Optional[str] = None,
                           window: Optional[int] = None
                           ) -> BoundedMutexPlan:
        """Bounded-wait FIFO mutex timeline: the plan form of
        ``lock(timeout=)``.

        Each requester carries a wait budget in ``timeouts`` (np.inf =
        unbounded). A requester whose turn would arrive after its budget
        burns its ticket — it is never granted and holds for zero time,
        exactly the live ``TicketMutex`` discipline. Burned tickets
        shorten every later wait, so the timeline is computed as a fixed
        point: replan the capacity-1 semaphore timeline (a mutex *is*
        the capacity-1 case, and the semaphore plan is the one form
        every backend reports per-requester grant times for; on
        ``cuda`` it is the semaphore kernel) with burned holds zeroed
        until the burned set stabilizes. Decisions fix in FIFO-prefix
        order, so at most N+1 replans are needed.

        The ``granted`` mask is the cross-backend equivalence object:
        every backend must agree with the step-exact numpy oracle
        (``kernels.ticket_lock.ticket_lock_bounded_oracle``)."""
        arrivals = np.asarray(arrivals, np.float32)
        holds = np.asarray(holds, np.float32)
        timeouts = np.asarray(timeouts, np.float32)
        n = arrivals.shape[0]
        if holds.shape != arrivals.shape or timeouts.shape != arrivals.shape:
            raise ValueError("arrivals/holds/timeouts must align")
        granted = np.ones(n, bool)
        live = holds.copy()
        plan = None
        iterations = 0
        for _ in range(n + 2):
            plan = self.plan_semaphore(arrivals, live, 1, backend=backend,
                                       window=window)
            iterations += 1
            # equality is "granted": the live mutex times out only when
            # the deadline strictly passes (small tolerance for the
            # float32 event clocks)
            now = (plan.grant - arrivals) <= timeouts + 1e-4
            if np.array_equal(now, granted):
                break
            granted = now
            live = np.where(granted, holds, 0.0).astype(np.float32)
        else:
            raise RuntimeError("bounded mutex plan did not stabilize")
        return BoundedMutexPlan(
            arrivals=arrivals, holds=holds, timeouts=timeouts,
            grant=np.asarray(plan.grant),
            release=np.asarray(plan.release),
            granted=granted, backend=plan.backend,
            iterations=iterations)

    def plan_barrier(self, present, required=None, *, epoch: int = 1,
                     flags=None, max_polls: int = 1024,
                     backend: Optional[str] = None,
                     window: Optional[int] = None) -> BarrierPlan:
        """One XF-barrier epoch: ``present`` slots arrive, the master
        checks ``required`` slots (default: all)."""
        present = np.asarray(present, np.int64)
        n = present.shape[0]
        required = (np.ones(n, np.int64) if required is None
                    else np.asarray(required, np.int64))
        flags = (np.zeros(n, np.int64) if flags is None
                 else np.asarray(flags, np.int64))
        bk = self._backend(backend)
        a, rel, done, strag = bk.plan_barrier(
            flags, epoch, present, required, max_polls=max_polls,
            window=window)
        return BarrierPlan(epoch=int(epoch), arrive=np.asarray(a),
                           release=np.asarray(rel), done=int(done),
                           stragglers=np.asarray(strag), required=required,
                           backend=bk.name)

    # ------------------------------------------------------------- hot loops
    def semaphore_planner(
        self, capacity: int, *, window: int = 32,
        backend: Optional[str] = None, device=None,
    ) -> Callable[[np.ndarray, np.ndarray],
                  Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """A raw ``(arrivals, holds) -> (grant, release, waited)`` numpy
        planner for scheduler hot loops, at a fixed window (power-of-2
        buckets above it). Arrivals must be sorted ascending. The
        backend defaults to :meth:`planning_backend_name` for
        ``device``."""
        bk = self._backend(backend or self.planning_backend_name(device))

        def plan(arrivals, holds):
            g, r, w, _ = bk.plan_semaphore(
                np.asarray(arrivals, np.float32),
                np.asarray(holds, np.float32), capacity, window=window)
            return g, r, w

        return plan
