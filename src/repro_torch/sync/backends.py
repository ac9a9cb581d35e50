"""Execution substrates for the sync library (counterpart of
``repro.sync.backends``).

  ``host`` — the threading implementations in ``core/hostsync``. Live
             objects are native; plans are produced by executing the
             live primitives under a planner-owned event clock and
             *observing* the grant order — what the cross-backend
             equivalence tests pin the kernels against.
  ``cuda`` — plans through the hand-written CUDA kernels.
  ``ref``  — plans through the kernels' plain versions on the CPU.

Live objects always run on the host control plane — a planning kernel
is not a resident lock — so every backend builds them the same way.
Each ``SyncLibrary`` owns its own ``host``/``cuda``/``ref`` objects (a
backend keeps the planning window whose one-time overflow warning it
reports); a name it does not own resolves through the module registry
(:func:`register_backend`, :func:`get_backend`), where a user plugs in a
backend of their own.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import hostsync
from repro_torch.core.abstraction import WaitStrategy

HOST_MUTEXES = {
    "spin": lambda strat: hostsync.SpinMutex(strategy=WaitStrategy.SPIN),
    "spin_backoff": lambda strat: hostsync.SpinMutex(
        strategy=WaitStrategy.SPIN_BACKOFF),
    "fa": lambda strat: hostsync.TicketMutex(strategy=strat),
    "ticket": lambda strat: hostsync.TicketMutex(strategy=strat),
    "futex": lambda strat: hostsync.FutexMutex(),
}
HOST_SEMAPHORES = {
    "spin": lambda n, strat: hostsync.SpinSemaphore(
        n, strategy=WaitStrategy.SPIN),
    "spin_backoff": lambda n, strat: hostsync.SpinSemaphore(
        n, strategy=WaitStrategy.SPIN_BACKOFF),
    "sleeping": lambda n, strat: hostsync.SleepingSemaphore(n, strategy=strat),
}
HOST_BARRIERS = {
    "xf": lambda p, strat: hostsync.XFBarrier(p, strategy=strat),
    "atomic": lambda p, strat: hostsync.CentralizedBarrier(p, strategy=strat),
    "centralized": lambda p, strat: hostsync.CentralizedBarrier(
        p, strategy=strat),
}

SemaphoreResult = Tuple[np.ndarray, np.ndarray, np.ndarray,
                        Optional[np.ndarray]]


class SyncBackend:
    """Base backend: live constructors on the host substrate."""

    name = "base"
    #: cheap, deterministic plans suitable for a scheduler hot loop
    fast_plans = False

    # ------------------------------------------------------------- live form
    def mutex(self, algorithm: str, strategy: WaitStrategy):
        return HOST_MUTEXES[algorithm](strategy)

    def semaphore(self, initial: int, algorithm: str,
                  strategy: WaitStrategy):
        return HOST_SEMAPHORES[algorithm](initial, strategy)

    def barrier(self, parties: int, algorithm: str,
                strategy: WaitStrategy):
        return HOST_BARRIERS[algorithm](parties, strategy)

    # ------------------------------------------------------------- plan form
    def plan_semaphore(self, arrivals, holds, capacity: int, *,
                       window: Optional[int] = None) -> SemaphoreResult:
        """(grant, release, waited, observed_order_or_None) for a trace
        sorted ascending by arrival."""
        raise NotImplementedError

    def plan_mutex(self, arrival, m, b, *, window: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
        """(grant_order, turn_trace, acc) for requesters in ``arrival``
        order (a permutation of 0..N-1)."""
        raise NotImplementedError

    def plan_barrier(self, arrive, epoch: int, present, required, *,
                     max_polls: int = 1024, window: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
        """(arrive', release, done, stragglers) for one barrier epoch."""
        raise NotImplementedError


class KernelBackend(SyncBackend):
    """Plans through the kernel modules on one device: ``cuda`` launches
    the CUDA kernels, ``cpu`` runs their plain versions. Kernel modules
    are imported on first use, so importing the library never reaches
    them."""

    fast_plans = True

    def __init__(self, name: str, device: str):
        self.name = name
        self.device = device
        self._window = None

    def plan_semaphore(self, arrivals, holds, capacity, *, window=None):
        if self._window is None:
            from repro_torch.kernels.semaphore import AdmissionWindow
            self._window = AdmissionWindow(self.device)
        g, r, w = self._window(arrivals, holds, capacity=capacity,
                               window=window if window else 32)
        return g, r, w, None

    def plan_mutex(self, arrival, m, b, *, window=None):
        from repro_torch.kernels.ticket_lock import ticket_lock_window
        g, t, acc = ticket_lock_window(arrival, m, b,
                                       window=window if window else 32,
                                       device=self.device)
        return np.asarray(g), np.asarray(t), float(acc)

    def plan_barrier(self, arrive, epoch, present, required, *,
                     max_polls=1024, window=None):
        from repro_torch.kernels.xf_barrier import xf_barrier_window
        a, rel, done, strag = xf_barrier_window(
            arrive, epoch, present, required, max_polls=max_polls,
            window=window if window else 32, device=self.device)
        return (np.asarray(a), np.asarray(rel), int(done),
                np.asarray(strag))


# ---------------------------------------------------------------------------
# Host backend: live primitives are native; plans execute them for real.
# ---------------------------------------------------------------------------

_POLL_S = 50e-6


def _wait_until(pred, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise RuntimeError(f"host plan stalled waiting for {what}")
        time.sleep(_POLL_S)


class HostBackend(SyncBackend):
    """Real threading primitives; plans are observed executions.

    The planning thread owns a virtual event clock (arrival and
    completion events processed in time order) while the *ordering*
    decisions — who enters, who is handed off next — are made by the real
    primitive under test.
    This is deliberately not fast: it exists to pin the kernel planners'
    semantics to the genuine Algorithm-3/5/XF implementations.
    """

    name = "host"
    fast_plans = False

    def plan_semaphore(self, arrivals, holds, capacity, *, window=None):
        del window
        arrivals = np.asarray(arrivals, np.float32)
        holds = np.asarray(holds, np.float32)
        n = int(arrivals.shape[0])
        if n == 0:
            z = np.zeros(0, np.float32)
            return z, z, np.zeros(0, np.int32), np.zeros(0, np.int64)
        if np.any(np.diff(arrivals) < 0):
            raise ValueError("arrivals must be sorted ascending")

        sem = hostsync.SleepingSemaphore(capacity)
        lock = threading.Lock()
        order = []
        release_ev = [threading.Event() for _ in range(n)]

        def worker(i):
            sem.wait()
            with lock:
                order.append(i)
            release_ev[i].wait(timeout=20.0)
            sem.post()

        def grants():
            with lock:
                return len(order)

        grant = np.zeros(n, np.float32)
        waited = np.zeros(n, np.int32)
        threads = []
        active: Dict[int, np.float32] = {}  # i -> release time
        queue = []                          # ticketed waiters, FIFO
        spawned = 0
        n_granted = 0  # planner-side count; grants only happen on our events
        n_tickets = 0  # tickets ever issued (over-capacity arrivals)
        inf = float("inf")
        while spawned < n or active:
            next_arr = float(arrivals[spawned]) if spawned < n else inf
            if active:
                rel_i = min(active, key=lambda j: (float(active[j]), j))
                next_rel = float(active[rel_i])
            else:
                next_rel = inf
            if next_rel <= next_arr:
                # ---- completion event: post() hands off to the oldest
                # waiter (Algorithm 5); a slot freeing exactly at an
                # arrival is processed first so the arrival sees it free.
                now = active.pop(rel_i)
                release_ev[rel_i].set()
                if queue:
                    j = queue.pop(0)
                    n_granted += 1
                    _wait_until(lambda: grants() >= n_granted,
                                "FIFO handoff")
                    grant[j] = now
                    active[j] = now + holds[j]
                else:
                    expect = len(active) + len(queue)
                    _wait_until(lambda: sem._count.load() == expect,
                                "post to drain")
            else:
                # ---- arrival event: spawn the requester; whether it
                # enters or tickets is the real semaphore's decision.
                i = spawned
                spawned += 1
                t = threading.Thread(target=worker, args=(i,))
                t.start()
                threads.append(t)
                expect = len(active) + len(queue) + 1
                _wait_until(lambda: sem._count.load() == expect,
                            "wait() entry")
                if len(active) < capacity:
                    n_granted += 1
                    _wait_until(lambda: grants() >= n_granted,
                                "immediate entry")
                    grant[i] = next_arr
                    active[i] = np.float32(next_arr) + holds[i]
                else:
                    # wait() is count.fetch_add *then* ticket.fetch_add;
                    # gate on the ticket too, or a preempted requester
                    # could let the next arrival steal its FIFO slot
                    n_tickets += 1
                    _wait_until(lambda: sem._ticket.load() == n_tickets,
                                "ticket issuance")
                    waited[i] = 1
                    queue.append(i)
        for t in threads:
            t.join()
        return grant, grant + holds, waited, np.asarray(order, np.int64)

    def plan_mutex(self, arrival, m=None, b=None, *, window=None):
        del window
        arrival = np.asarray(arrival, np.int64)
        n = int(arrival.shape[0])
        if n == 0:
            z = np.zeros(0, np.int64)
            return z, z, 0.0
        m = np.ones(n, np.float32) if m is None else np.asarray(m, np.float32)
        b = np.zeros(n, np.float32) if b is None else np.asarray(b, np.float32)
        mtx = hostsync.TicketMutex(strategy=WaitStrategy.SLEEP)
        order, turns = [], []
        acc = [np.float32(0.0)]
        everyone_queued = threading.Event()

        def worker(j):
            mtx.lock()
            if not order:
                # first holder stalls inside the critical section until
                # every later requester holds a ticket — real contention,
                # so the FIFO drain below is a meaningful observation
                everyone_queued.wait(timeout=20.0)
            order.append(int(arrival[j]))
            turns.append(int(mtx._turn))
            acc[0] = acc[0] * m[j] + b[j]
            mtx.unlock()

        threads = []
        for j in range(n):
            t = threading.Thread(target=worker, args=(j,))
            t.start()
            threads.append(t)
            # ticket issuance must follow arrival order: each requester
            # holds its ticket before the next one is spawned
            _wait_until(lambda: mtx._ticket.load() == j + 1,
                        "ticket issuance")
        everyone_queued.set()
        for t in threads:
            t.join()
        return (np.asarray(order, np.int64), np.asarray(turns, np.int64),
                float(acc[0]))

    def plan_barrier(self, arrive, epoch, present, required, *,
                     max_polls=1024, window=None, timeout_s=0.5):
        del max_polls, window
        arrive = np.asarray(arrive, np.int64)
        present = np.asarray(present, np.int64) > 0
        required = np.asarray(required, np.int64) > 0
        n = int(arrive.shape[0])
        epoch = int(epoch)
        if n == 0:
            # vacuous completion, matching the kernel/ref semantics
            z = np.zeros(0, np.int64)
            return z, z, 1, z

        bar = hostsync.XFBarrier(n, strategy=WaitStrategy.SPIN_BACKOFF,
                                 required=required.tolist())
        bar._arrive = [int(a) for a in arrive]
        bar._epochs = [epoch - 1] * n

        results = {}

        def worker(rank):
            results[rank] = bar.arrive_and_wait(rank, timeout=timeout_s)

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(n) if present[r]]
        for t in threads:
            t.start()
        master_present = bool(n) and bool(present[0])
        if not master_present:
            # rank 0 is the XF master; when it is absent the planning
            # thread plays master (scan required flags, broadcast on
            # success) so the host run keeps the kernel's semantics (the
            # kernel's master is a CTA that always runs).
            deadline = time.monotonic() + timeout_s
            ok = False
            while time.monotonic() < deadline:
                if all(bar._arrive[k] >= epoch
                       for k in range(n) if required[k]):
                    ok = True
                    break
                time.sleep(_POLL_S)
            if ok:
                for k in range(n):
                    bar._release[k] = epoch
            done = int(ok)
        else:
            for t in threads:
                t.join()
            done = int(results.get(0, False))
        for t in threads:
            t.join()

        new_arrive = np.asarray(bar._arrive, np.int64)
        stragglers = np.where(required & (new_arrive < epoch), 1, 0)
        release = np.asarray(bar._release, np.int64)
        return new_arrive, release, done, stragglers.astype(np.int64)


def make_backends() -> Dict[str, SyncBackend]:
    return {"host": HostBackend(), "cuda": KernelBackend("cuda", "cuda"),
            "ref": KernelBackend("ref", "cpu")}


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, SyncBackend] = {}


def register_backend(name: str, backend: SyncBackend) -> SyncBackend:
    """Register (or replace) a backend under ``name``."""
    backend.name = name
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str) -> SyncBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sync backend {name!r}; available: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


for _name, _backend in make_backends().items():
    register_backend(_name, _backend)
