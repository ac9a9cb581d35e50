"""Host-row primitive benchmarks: the paper's Figure-2/3 sweeps with real
threads on the host CPU (measured tier), comparing spin / spin+backoff /
FA mutexes, spin vs sleeping semaphores, XF vs centralized barriers, and
the host-only futex.

Counterpart of ``benchmarks/hostbench.py``: the same rows, names and
sizes over the port's ``core.hostsync``. Nothing here runs on the card;
the rates are the host CPU's, so a row is quoted beside that CPU's
model (:func:`cpu_model`).

    python -m repro_torch.benchmarks.hostbench [--threads 8] [--ops 300]

Each row is ``name,us_per_call,derived`` (the whole sweep's wall time
in microseconds, then the rate).
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, List

from repro_torch.core.abstraction import WaitStrategy
from repro_torch.core.hostsync import (CentralizedBarrier, FutexMutex,
                                       SleepingSemaphore, SpinMutex,
                                       SpinSemaphore, TicketMutex, XFBarrier)


def cpu_model(path: str = "/proc/cpuinfo") -> str:
    """The host CPU from ``/proc/cpuinfo``: its model name — or, where a
    virtual machine hides it, vendor, family and model numbers — and its
    count of logical CPUs. Empty where the file is missing."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return ""
    first = dict(line.split(":", 1) for line in
                 text.split("\n\n")[0].splitlines() if ":" in line)
    info = {k.strip(): v.strip() for k, v in first.items()}
    name = info.get("model name", "")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')}")
    n = sum(line.startswith("processor") for line in text.splitlines())
    return f"{name}, {n} cpus"


def _run_threads(n: int, fn: Callable[[int], None]) -> float:
    start = threading.Barrier(n + 1)
    done = threading.Barrier(n + 1)

    def runner(tid):
        start.wait()
        fn(tid)
        done.wait()

    ts = [threading.Thread(target=runner, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    done.wait()
    dt = time.perf_counter() - t0
    for t in ts:
        t.join()
    return dt


def bench_mutex(make, threads: int, ops: int) -> float:
    m = make()

    def work(tid):
        for _ in range(ops):
            m.lock()
            m.unlock()

    dt = _run_threads(threads, work)
    return threads * ops / dt


def bench_semaphore(make, threads: int, ops: int) -> float:
    s = make()

    def work(tid):
        for _ in range(ops):
            s.wait()
            s.post()

    dt = _run_threads(threads, work)
    return threads * ops / dt


def bench_barrier(make, threads: int, ops: int) -> float:
    b = make(threads)

    def work(tid):
        for _ in range(ops):
            b.arrive_and_wait(tid)

    dt = _run_threads(threads, work)
    return ops / dt


def main(threads: int = 8, ops: int = 300) -> List[str]:
    rows: List[str] = []

    cases = [
        ("host_mutex_spin", lambda: SpinMutex(WaitStrategy.SPIN)),
        ("host_mutex_spin_backoff",
         lambda: SpinMutex(WaitStrategy.SPIN_BACKOFF)),
        ("host_mutex_fa", lambda: TicketMutex()),
        ("host_mutex_futex", lambda: FutexMutex()),
    ]
    for name, make in cases:
        t0 = time.perf_counter()
        ops_s = bench_mutex(make, threads, ops)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(f"{name}_t{threads},{us:.1f},ops_per_s={ops_s:.0f}")

    for init in (1, 4):
        for name, make in (
                ("host_sem_spin", lambda i=init: SpinSemaphore(i)),
                ("host_sem_sleeping", lambda i=init: SleepingSemaphore(i))):
            t0 = time.perf_counter()
            ops_s = bench_semaphore(make, threads, ops)
            us = (time.perf_counter() - t0) * 1e6
            rows.append(
                f"{name}{init}_t{threads},{us:.1f},ops_per_s={ops_s:.0f}")

    for name, make in (("host_barrier_xf", XFBarrier),
                       ("host_barrier_centralized", CentralizedBarrier)):
        t0 = time.perf_counter()
        ops_s = bench_barrier(make, threads, max(ops // 4, 25))
        us = (time.perf_counter() - t0) * 1e6
        rows.append(f"{name}_t{threads},{us:.1f},barriers_per_s={ops_s:.0f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--ops", type=int, default=300)
    cli = ap.parse_args()
    print(f"# host cpu: {cpu_model()}")
    for r in main(cli.threads, cli.ops):
        print(r)
