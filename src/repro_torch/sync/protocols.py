"""Uniform primitive protocols and the semaphore plan type (the part of
``repro.sync.protocols`` the serving path uses).

Every primitive is usable two ways: as a live object on the host
control plane (``lock()/unlock()``, ``wait()/post()``) and, for the
semaphore, as a deterministic plan — FIFO fairness makes the
Algorithm-5 timeline a function of the trace, which is what lets the
serving scheduler use the semaphore as an admission *planner*.
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


@dataclasses.dataclass
class SemaphorePlan:
    """Algorithm-5 admission timeline for a FIFO request trace."""

    arrivals: np.ndarray   # [N] request arrival times
    grant: np.ndarray      # [N] grant times
    release: np.ndarray    # [N] release times (grant + hold)
    waited: np.ndarray     # [N] 1 if the request queued (took a ticket)
    capacity: int
    backend: str = ""

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
