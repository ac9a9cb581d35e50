"""Execution substrates for the sync library (counterpart of
``repro.sync.backends``).

  ``host`` — the threading implementations in ``core/hostsync``. Live
             objects are native; its observed-execution plans are not
             ported yet.
  ``cuda`` — plans through the hand-written CUDA kernels.
  ``ref``  — plans through the kernels' plain versions on the CPU.

Live objects always run on the host control plane — a planning kernel
is not a resident lock — so every backend builds them the same way.
Each ``SyncLibrary`` owns its own backend objects (no process-wide
registry): a backend keeps the planning window whose one-time overflow
warning it reports.
"""

from __future__ import annotations

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
}
HOST_SEMAPHORES = {
    "spin": lambda n, strat: hostsync.SpinSemaphore(
        n, strategy=WaitStrategy.SPIN),
    "spin_backoff": lambda n, strat: hostsync.SpinSemaphore(
        n, strategy=WaitStrategy.SPIN_BACKOFF),
    "sleeping": lambda n, strat: hostsync.SleepingSemaphore(n, strategy=strat),
}

Plan = Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]


class SyncBackend:
    """Base backend: live constructors on the host substrate."""

    name = "base"
    #: cheap, deterministic plans suitable for a scheduler hot loop
    fast_plans = False

    def mutex(self, algorithm: str, strategy: WaitStrategy):
        if algorithm not in HOST_MUTEXES:
            raise ValueError(f"mutex algorithm {algorithm!r} is not ported "
                             f"yet; have {sorted(HOST_MUTEXES)}")
        return HOST_MUTEXES[algorithm](strategy)

    def semaphore(self, initial: int, algorithm: str,
                  strategy: WaitStrategy):
        return HOST_SEMAPHORES[algorithm](initial, strategy)

    def plan_semaphore(self, arrivals, holds, capacity: int, *,
                       window: Optional[int] = None) -> Plan:
        """(grant, release, waited, observed_order_or_None) for a trace
        sorted ascending by arrival."""
        raise NotImplementedError(
            f"{self.name}: semaphore plans on this backend are not "
            f"ported yet")


class KernelBackend(SyncBackend):
    """Plans through ``kernels.semaphore`` on one device: ``cuda``
    launches the CUDA kernel, ``cpu`` runs its plain version."""

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


class HostBackend(SyncBackend):
    """Real threading primitives. The reference also plans by running
    them under an observed event clock; that is not ported yet."""

    name = "host"


def make_backends() -> Dict[str, SyncBackend]:
    return {"host": HostBackend(), "cuda": KernelBackend("cuda", "cuda"),
            "ref": KernelBackend("ref", "cpu")}
