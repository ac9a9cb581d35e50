"""Backend-unified synchronization library (counterpart of
``repro.sync.library``, the serving path's part of it).

The machine abstraction picks an *(backend, algorithm, wait-strategy)*
triple and every axis can be pinned:

    lib = SyncLibrary.host_default()           # nominal host abstraction
    m = lib.mutex(kind="ticket")               # live Algorithm-3 mutex
    s = lib.semaphore(8)                       # live Algorithm-5 semaphore
    plan = lib.plan_semaphore(arrivals, holds, capacity=8)
    planner = lib.semaphore_planner(8, window=64, device="cuda")

Live objects run on the host; plans run on the ``cuda`` kernel or its
plain version (``ref``). Mutex and barrier plans, and the barriers
themselves, wait for the slices that port their kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

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

from .backends import SyncBackend, make_backends
from .protocols import SemaphorePlan

# A nominal host abstraction for when probing is not worth it (serving
# constructors). Classifies as "balanced": fa mutex, sleeping semaphore.
HOST_NOMINAL = MachineAbstraction(
    name="host-nominal",
    reads=BenchTimes(1.0, 0.5, 5.0, 2.5, 1.2, 0.6),
    writes=BenchTimes(1.0, 0.5, 5.0, 2.5, 1.2, 0.6),
    saturated_blocks=8,
)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


@dataclasses.dataclass
class SyncLibrary:
    """Primitive factory + planner over one machine abstraction.
    ``backend`` / ``*_kind`` / ``strategy`` pin the selection triple's
    axes; ``None`` lets ``select_impl`` decide from the machine."""

    machine: MachineAbstraction
    backend: Optional[str] = None
    mutex_kind: Optional[str] = None
    semaphore_kind: Optional[str] = None
    strategy: Optional[WaitStrategy] = None
    _backends: Dict[str, SyncBackend] = dataclasses.field(
        default_factory=make_backends, init=False, repr=False)

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
        name = name or self.backend_name()
        try:
            return self._backends[name]
        except KeyError:
            raise KeyError(f"unknown sync backend {name!r}; available: "
                           f"{', '.join(sorted(self._backends))}") from None

    def planning_backend_name(self, device=None) -> str:
        """Backend for hot-loop planning: the pinned/selected backend if
        it plans cheaply, else the CUDA kernel when ``device`` is a CUDA
        device and its plain version otherwise."""
        name = self.backend_name()
        if self._backend(name).fast_plans:
            return name
        if device is not None and torch.device(device).type == "cuda":
            return "cuda"
        return "ref"

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
        g, r, w, _ = bk.plan_semaphore(arrivals[perm], holds[perm],
                                       capacity, window=window)
        inv = np.argsort(perm, kind="stable")
        return SemaphorePlan(arrivals=arrivals, grant=np.asarray(g)[inv],
                             release=np.asarray(r)[inv],
                             waited=np.asarray(w)[inv], capacity=capacity,
                             backend=bk.name)

    def plan_mutex(self, *args, **kw):
        _not_ported("plan_mutex (the ticket-lock kernel)")

    def plan_barrier(self, *args, **kw):
        _not_ported("plan_barrier (the XF-barrier kernel)")

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
