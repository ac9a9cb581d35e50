"""Cluster control plane built on the paper's primitives (hostsync):
the port's copy of ``repro.core.coordinator``, on the port's
``core/hostsync.py``.

At thousand-node scale, the expensive failure modes are coordination, not
math: every step ends in a synchronization point, checkpoints need
quiescence, membership changes need mutual exclusion, and stragglers need to
be *detected* rather than silently stretching every step. This module
provides those services using the paper's primitives with the paper's
design rule (bound + front-load serializing ops, then poll):

  * ``ClusterCoordinator.step_barrier`` — an XF flag barrier with a deadline;
    on timeout it returns the exact straggler set (unset arrive flags — a
    diagnostic a centralized atomic counter fundamentally cannot give).
  * heartbeats — each host *owns* its heartbeat word (single-writer, no
    atomics — the XF trick); the monitor scans them (one reader).
  * membership — epoch-numbered view guarded by a ticket mutex (FIFO-fair, so
    a rejoining host cannot starve an eviction, and one atomic per change).
  * checkpoint quiescence — two-phase: barrier, then single-writer epoch bump.

In-process this coordinates threads (tests/examples); across real hosts the
same state machine runs over a KV store via ``KVStore`` — both back ends are
exercised in tests. The KV back end models what a cluster's coordination
service (a key-value store every host can reach) provides.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Protocol

from .abstraction import WaitStrategy
from .hostsync import Backoff, TicketMutex, XFBarrier, _wait


class KVStore(Protocol):
    """Minimal coordination KV interface."""

    def get(self, key: str) -> Optional[str]: ...
    def set(self, key: str, value: str) -> None: ...


class InMemoryKV:
    """Single-process KVStore used by tests and the in-process coordinator."""

    def __init__(self):
        self._d: Dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[str]:
        return self._d.get(key)  # GIL-atomic read

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._d[key] = value


@dataclasses.dataclass
class BarrierOutcome:
    ok: bool
    epoch: int
    stragglers: List[int]
    wait_s: float


@dataclasses.dataclass
class MembershipView:
    epoch: int
    alive: List[int]

    @property
    def world_size(self) -> int:
        return len(self.alive)


class ClusterCoordinator:
    """Step/checkpoint/membership coordination for ``world`` hosts."""

    def __init__(
        self,
        world: int,
        *,
        barrier_timeout_s: float = 30.0,
        heartbeat_lag_steps: int = 3,
        strategy: WaitStrategy = WaitStrategy.SPIN_BACKOFF,
    ):
        self.world = world
        self.barrier_timeout_s = barrier_timeout_s
        self.heartbeat_lag_steps = heartbeat_lag_steps
        self._barrier = XFBarrier(world, strategy=strategy)
        self._member_mutex = TicketMutex()      # FA mutex guards membership
        self._heartbeats = [0] * world          # single-writer per rank
        self._hb_times = [0.0] * world
        self._alive = list(range(world))
        self._epoch = 0
        self._ckpt_epoch = 0

    # ------------------------------------------------------------- barriers
    def step_barrier(self, rank: int,
                     timeout_s: Optional[float] = None) -> BarrierOutcome:
        """End-of-step synchronization with straggler attribution."""
        t0 = time.monotonic()
        timeout = self.barrier_timeout_s if timeout_s is None else timeout_s
        ok = self._barrier.arrive_and_wait(rank, timeout=timeout)
        stragglers = [] if ok else self._barrier.waiting_on()
        return BarrierOutcome(
            ok=ok,
            epoch=self._epoch,
            stragglers=stragglers,
            wait_s=time.monotonic() - t0,
        )

    # ----------------------------------------------------------- heartbeats
    def heartbeat(self, rank: int, step: int) -> None:
        """Single-writer: rank owns its word (no atomics — the XF rule)."""
        self._heartbeats[rank] = step
        self._hb_times[rank] = time.monotonic()

    def stragglers(self, *, now_step: Optional[int] = None,
                   stale_s: Optional[float] = None) -> List[int]:
        """Hosts behind by > heartbeat_lag_steps (or silent for stale_s)."""
        lead = now_step if now_step is not None else max(
            (self._heartbeats[r] for r in self._alive), default=0)
        out = []
        now = time.monotonic()
        for r in self._alive:
            lagging = lead - self._heartbeats[r] > self.heartbeat_lag_steps
            silent = stale_s is not None and now - self._hb_times[r] > stale_s
            if lagging or silent:
                out.append(r)
        return out

    # ----------------------------------------------------------- membership
    def view(self) -> MembershipView:
        return MembershipView(epoch=self._epoch, alive=list(self._alive))

    def evict(self, rank: int) -> MembershipView:
        """Remove a failed/straggling host; bumps the membership epoch.

        One ticket-mutex acquisition (one atomic) per membership change;
        readers of the view never take the lock (epoch-stamped copy).
        """
        with self._member_mutex:
            if rank in self._alive:
                self._alive.remove(rank)
                self._epoch += 1
        return self.view()

    def join(self, rank: int) -> MembershipView:
        with self._member_mutex:
            if rank not in self._alive:
                self._alive.append(rank)
                self._alive.sort()
                self._epoch += 1
            # A membership change invalidates in-flight barriers: rebuild.
            self._barrier = XFBarrier(len(self._alive))
        return self.view()

    # ----------------------------------------------------- checkpoint fence
    def checkpoint_fence(self, rank: int,
                         timeout_s: Optional[float] = None) -> bool:
        """Quiesce all hosts before a checkpoint epoch (two-phase).

        Phase 1: everyone reaches the barrier (no host is mid-step).
        Phase 2: rank 0 bumps the checkpoint epoch (single writer);
        everyone polls it — zero atomics after the barrier, per the paper.

        The target epoch is captured *before* arriving: every rank is
        pre-barrier at capture time, and rank 0 only bumps post-barrier, so
        all ranks agree on the target (no read-after-bump race).
        """
        target = self._ckpt_epoch + 1
        out = self.step_barrier(rank, timeout_s)
        if not out.ok:
            return False
        if rank == 0:
            self._ckpt_epoch = target
            return True
        return _wait(lambda: self._ckpt_epoch >= target,
                     WaitStrategy.SPIN_BACKOFF, Backoff(1, 16),
                     timeout_s or self.barrier_timeout_s)


class KVCoordinator:
    """The same coordination protocol over a KVStore (multi-process form).

    Every host writes only its own keys (``hb/<rank>``,
    ``arrive/<epoch>/<rank>``) — single-writer everywhere, the paper's XF
    rule — so the KV store needs no compare-and-swap for the steady-state
    path.
    """

    def __init__(self, kv: KVStore, world: int, rank: int,
                 *, barrier_timeout_s: float = 30.0):
        self.kv = kv
        self.world = world
        self.rank = rank
        self.barrier_timeout_s = barrier_timeout_s
        self._epoch = 0

    def heartbeat(self, step: int) -> None:
        self.kv.set(f"hb/{self.rank}", str(step))

    def read_heartbeats(self) -> Dict[int, int]:
        out = {}
        for r in range(self.world):
            v = self.kv.get(f"hb/{r}")
            if v is not None:
                out[r] = int(v)
        return out

    def barrier(self, timeout_s: Optional[float] = None) -> BarrierOutcome:
        self._epoch += 1
        epoch = self._epoch
        t0 = time.monotonic()
        self.kv.set(f"arrive/{epoch}/{self.rank}", "1")
        timeout = (timeout_s if timeout_s is not None
                   else self.barrier_timeout_s)

        if self.rank == 0:
            def _all_arrived() -> bool:
                return all(
                    self.kv.get(f"arrive/{epoch}/{r}") is not None
                    for r in range(self.world)
                )
            ok = _wait(_all_arrived, WaitStrategy.SPIN_BACKOFF,
                       Backoff(1, 32), timeout)
            if ok:
                self.kv.set(f"release/{epoch}", "1")
            stragglers = [] if ok else [
                r for r in range(self.world)
                if self.kv.get(f"arrive/{epoch}/{r}") is None
            ]
            return BarrierOutcome(ok, epoch, stragglers,
                                  time.monotonic() - t0)

        ok = _wait(lambda: self.kv.get(f"release/{epoch}") is not None,
                   WaitStrategy.SPIN_BACKOFF, Backoff(1, 32), timeout)
        return BarrierOutcome(ok, epoch, [], time.monotonic() - t0)
