"""Classify *this host* with the paper's 12-benchmark method (Section 3);
a copy of ``repro.core.hostbench_probe`` for the PyTorch port, on the
port's ``hostsync.AtomicWord``.

Measures, with real threads on real shared words:

  * contentious / noncontentious x atomic / volatile x read / write
  * the "volatile preceded by atomic" probes (P3)

and packs them into a ``MachineAbstraction`` so ``select_impl`` can choose
host-side implementations the same way it does for Tesla/Fermi. The
"atomic" is an ``AtomicWord`` RMW (lock round trip); the "volatile" is a
plain int attribute access. Python's GIL serializes bytecode, so the
*contentious vs noncontentious* axis is muted compared to real silicon —
the interesting, large ratio on a host is atomic:volatile (P1), which is
exactly the paper's primary parameter.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from .abstraction import BenchTimes, MachineAbstraction
from .hostsync import AtomicWord


class _Slot:
    """One word with padding so noncontentious slots don't share cachelines."""

    __slots__ = ("word", "_pad")

    def __init__(self):
        self.word = AtomicWord(0)
        self._pad = [0] * 16


def _run_threads(n: int, fn: Callable[[int], None]) -> float:
    start = threading.Barrier(n + 1)
    done = threading.Barrier(n + 1)

    def runner(tid: int):
        start.wait()
        fn(tid)
        done.wait()

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    done.wait()
    dt = time.perf_counter() - t0
    for t in threads:
        t.join()
    return dt


def _bench(threads: int, accesses: int, *, atomic: bool, contentious: bool,
           write: bool, preceded_by_atomic: bool = False) -> float:
    """Return time in ms normalized to 1000 accesses/thread (Table 1 units)."""
    slots: List[_Slot] = [_Slot() for _ in range(1 if contentious else threads)]

    def body(tid: int):
        slot = slots[0 if contentious else tid]
        w = slot.word
        if preceded_by_atomic:
            w.fetch_add(0)
        if atomic:
            if write:
                for _ in range(accesses):
                    w.exch(0)
            else:
                for _ in range(accesses):
                    w.fetch_add(0)
        else:
            if write:
                for _ in range(accesses):
                    w.store(1)
            else:
                acc = 0
                for _ in range(accesses):
                    acc += w.load()

    dt = _run_threads(threads, body)
    return dt * 1e3 * (1000.0 / accesses)


def classify_host(threads: int = 8, accesses: int = 20000) -> MachineAbstraction:
    """Run the paper's benchmark grid on this host; return its abstraction."""
    def grid(write: bool) -> BenchTimes:
        return BenchTimes(
            contentious_volatile=_bench(threads, accesses, atomic=False,
                                        contentious=True, write=write),
            noncontentious_volatile=_bench(threads, accesses, atomic=False,
                                           contentious=False, write=write),
            contentious_atomic=_bench(threads, accesses, atomic=True,
                                      contentious=True, write=write),
            noncontentious_atomic=_bench(threads, accesses, atomic=True,
                                         contentious=False, write=write),
            contentious_volatile_after_atomic=_bench(
                threads, accesses, atomic=False, contentious=True,
                write=write, preceded_by_atomic=True),
            noncontentious_volatile_after_atomic=_bench(
                threads, accesses, atomic=False, contentious=False,
                write=write, preceded_by_atomic=True),
        )

    return MachineAbstraction(
        name="host-cpu",
        reads=grid(write=False),
        writes=grid(write=True),
        saturated_blocks=threads,
    )
