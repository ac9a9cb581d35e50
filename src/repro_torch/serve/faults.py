"""Deterministic fault injection for the serving stack (counterpart of
``repro.serve.faults``; numpy only, so the port keeps its own copy).

A :class:`FaultPlan` is a pure function of ``(seed, site,
occurrence-index)``: the k-th time a given injection site is consulted,
the decision to fault is drawn from ``np.random.default_rng([seed,
site_id, k])``, independent of wall clock, thread interleaving, or how
many *other* sites fired in between. ``_SITE_IDS`` and the draw order are
the reference's, so one seed injects the same faults at the same points
in both packages, and a replay of the same workload under the same seed
injects the same faults again.

Injection sites
---------------

``alloc_hook(stage)``
    Installed as ``PagePool.fault_hook``; fires *inside* the allocator's
    critical section at named batch stages (``alloc:grant``,
    ``free:decrefs``, ...). Raises :class:`InjectedFault` to abort the
    batch mid-mutation (exercising the undo log), or sleeps past the
    lock watchdog threshold to simulate a stuck holder.

``dispatch(active_rids)``
    Called by ``SlotServeEngine`` just before a round's dispatch, before
    any device work. Raises to simulate a failed dispatch. When
    ``poison_rid`` is set, the fault fires on *every* round in which that
    request is active — the blame signal the engine's quarantine
    consumes (after N consecutive failures it removes the request, and
    the faults stop).

``executor()``
    Called by ``AsyncFrontend._drive`` before handing ``engine.step`` to
    the thread-pool executor. Raises to simulate executor death; the
    engine state is untouched (the step never started), so the frontend
    recovers by retrying the round.

All sites honor :meth:`suspended`, a context manager the *recovery*
paths use for compensation work (e.g. re-applying planned cache
evictions after an aborted admission batch) that must not itself be
faulted — otherwise an unlucky seed could wedge recovery forever.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

#: site name -> stable id mixed into the per-draw PRNG key. Append-only:
#: reordering or renaming changes every seeded plan.
_SITE_IDS = {
    "alloc": 1,
    "dispatch": 2,
    "executor": 3,
    "stuck": 4,
}


class InjectedFault(RuntimeError):
    """A deliberately injected failure.

    ``kind`` names the injection site; ``rid`` (optional) is the request
    the fault is attributed to — the engine's quarantine logic blames
    this request when deciding what to evict after repeated round
    failures.
    """

    def __init__(self, kind: str, rid: Optional[int] = None,
                 detail: str = ""):
        self.kind = kind
        self.rid = rid
        msg = f"injected fault [{kind}]"
        if rid is not None:
            msg += f" rid={rid}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class FaultPlan:
    """Seeded, counter-keyed fault schedule shared by all injection
    sites in one serving stack.

    Parameters
    ----------
    seed:
        PRNG seed; same seed + same workload = same faults.
    alloc_rate:
        Probability an allocator batch *stage* aborts (fires inside the
        critical section; the undo log must roll the batch back).
    dispatch_rate:
        Probability a round dispatch raises.
    executor_rate:
        Probability the frontend's executor submission raises.
    stuck_rate:
        Probability an allocator stage *sleeps* ``stuck_hold_s`` instead
        of raising — a slow/stuck lock holder, which should trip the
        mutex watchdog but complete normally.
    stuck_hold_s:
        How long a stuck holder sleeps (set just past the pool's
        watchdog threshold in tests).
    poison_rid:
        When set, ``dispatch`` faults deterministically whenever this
        request id is active (in addition to the random rate) — the
        repeatable-failure signal quarantine tests rely on.
    max_faults:
        Hard cap on total injected faults (None = unbounded). Keeps
        chaos runs terminating even at high rates.
    max_per_kind:
        Optional per-kind caps, e.g. ``{"alloc": 1, "stuck": 2}`` — the
        chaos benchmark uses this to fire every kind at high rates
        while bounding the recovery overhead each kind adds (the
        lock-ledger gate compares against the fault-free baseline).
        Kinds absent from the dict are uncapped (up to ``max_faults``).
    """

    def __init__(self, seed: int, *,
                 alloc_rate: float = 0.0,
                 dispatch_rate: float = 0.0,
                 executor_rate: float = 0.0,
                 stuck_rate: float = 0.0,
                 stuck_hold_s: float = 0.0,
                 poison_rid: Optional[int] = None,
                 max_faults: Optional[int] = None,
                 max_per_kind: Optional[Dict[str, int]] = None):
        self.seed = int(seed)
        self.alloc_rate = float(alloc_rate)
        self.dispatch_rate = float(dispatch_rate)
        self.executor_rate = float(executor_rate)
        self.stuck_rate = float(stuck_rate)
        self.stuck_hold_s = float(stuck_hold_s)
        self.poison_rid = poison_rid
        self.max_faults = max_faults
        self.max_per_kind = dict(max_per_kind or {})
        self.injected = 0
        self.by_kind: Dict[str, int] = {}
        self.stuck_holds = 0
        self._draws: Dict[str, int] = {}
        self._suspended = 0

    # ------------------------------------------------------------ internals
    def _draw(self, site: str) -> float:
        """The k-th consult of ``site`` always sees the same uniform."""
        k = self._draws.get(site, 0)
        self._draws[site] = k + 1
        rng = np.random.default_rng([self.seed, _SITE_IDS[site], k])
        return float(rng.random())

    def _budget_left(self, kind: str) -> bool:
        if self.max_faults is not None and self.injected >= self.max_faults:
            return False
        cap = self.max_per_kind.get(kind)
        return cap is None or self.by_kind.get(kind, 0) < cap

    def _record(self, kind: str) -> None:
        self.injected += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1

    @contextlib.contextmanager
    def suspended(self) -> Iterator[None]:
        """Disable injection for the duration — recovery/compensation
        paths run under this so the rollback of a fault cannot itself
        be faulted."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    @property
    def active(self) -> bool:
        return self._suspended == 0

    # ------------------------------------------------------------ sites
    def alloc_hook(self, stage: str) -> None:
        """``PagePool.fault_hook`` adapter: abort or stall a batch stage.

        Draw order is fixed (stuck first, then abort) so the schedule
        for one rate is unchanged by enabling the other.
        """
        if not self.active:
            return
        stuck = (self.stuck_rate > 0.0
                 and self._draw("stuck") < self.stuck_rate)
        abort = (self.alloc_rate > 0.0
                 and self._draw("alloc") < self.alloc_rate)
        if stuck and self._budget_left("stuck"):
            self._record("stuck")
            self.stuck_holds += 1
            time.sleep(self.stuck_hold_s)
        if abort and self._budget_left("alloc"):
            self._record("alloc")
            raise InjectedFault("alloc", detail=stage)

    def dispatch(self, active_rids: Sequence[int] = ()) -> None:
        """Fault gate before the engine's round dispatch."""
        if not self.active:
            return
        rids = list(active_rids)
        if (self.poison_rid is not None and self.poison_rid in rids
                and self._budget_left("dispatch")):
            self._record("dispatch")
            raise InjectedFault("dispatch", rid=self.poison_rid,
                                detail="poisoned request active")
        if (self.dispatch_rate > 0.0
                and self._draw("dispatch") < self.dispatch_rate
                and self._budget_left("dispatch")):
            self._record("dispatch")
            rid = rids[-1] if rids else None
            raise InjectedFault("dispatch", rid=rid)

    def executor(self) -> None:
        """Fault gate before the frontend hands a step to its executor."""
        if not self.active:
            return
        if (self.executor_rate > 0.0
                and self._draw("executor") < self.executor_rate
                and self._budget_left("executor")):
            self._record("executor")
            raise InjectedFault("executor")

    # ------------------------------------------------------------ reporting
    def stats(self) -> Dict[str, object]:
        return {
            "fault_seed": self.seed,
            "faults_injected": self.injected,
            "faults_by_kind": dict(self.by_kind),
            "stuck_holds": self.stuck_holds,
        }
