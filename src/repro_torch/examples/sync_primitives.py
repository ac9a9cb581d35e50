"""The paper's contribution through the unified ``repro_torch.sync`` API
(twin of the repository's ``examples/sync_primitives.py``):

  1. classify machines via the 12-benchmark machine abstraction
     (simulated Tesla/Fermi + this host, measured once and cached) and
     show the (backend, algorithm, wait-strategy) selection triples;
  2. reproduce the headline comparisons (Figure 2, simulated);
  3. plan the *same* primitive trace on three backends — real host
     threads, the CUDA kernel, its plain version — and check they agree
     (the library's portability claim, live);
  4. run the paper-derived control plane: an XF barrier detecting a
     straggler, semaphore admission planned on the device's planner.

    PYTHONPATH=src python -m repro_torch.examples.sync_primitives
    PYTHONPATH=src python -m repro_torch.examples.sync_primitives --device cpu

On ``--device cpu`` the trace is planned on ``host`` and ``ref`` only
(the CUDA kernel has no CPU mode); without it the example needs a card.
"""

import argparse
import threading

import numpy as np

from repro_torch.core.abstraction import (FERMI, TESLA, TPU_V5E,
                                          PrimitiveKind, classify)
from repro_torch.core.coordinator import ClusterCoordinator
from repro_torch.core.device import resolve_device
from repro_torch.core.primitives_sim import run_primitive
from repro_torch.serve.scheduler import plan_admission
from repro_torch.sync import SyncLibrary

# How long the control-plane demo waits for each rank's thread.
JOIN_TIMEOUT_S = 30.0


def classify_machines():
    print("== machine abstraction (P1 atomic:volatile, P2 contention, P3 hostage)")
    # for_host() probes once per process per probe-parameter set
    # (cached; refresh=True re-probes)
    host_lib = SyncLibrary.for_host(threads=4, accesses=4000)
    assert (SyncLibrary.for_host(threads=4, accesses=4000).machine
            is host_lib.machine)  # cache hit
    for m in (TESLA, FERMI, host_lib.machine):
        s = m.summary()
        print(f"  {m.name:14s} P1={s['P1_atomic_volatile_ratio']:6.1f} "
              f"P2={s['P2_contention_ratio']:5.2f} "
              f"P3={int(s['P3_line_hostage'])}  class={classify(m)}")

    print("\n== selection triples (backend, algorithm, wait strategy)")
    for machine in (TESLA, FERMI, TPU_V5E, host_lib.machine):
        lib = SyncLibrary(machine=machine)
        for prim in PrimitiveKind:
            c = lib.choice(prim, semaphore_initial=10)
            print(f"  {machine.name:14s} {prim.value:9s} -> "
                  f"({c.backend:6s}, {c.algorithm:13s}, {c.strategy.value})")
    return host_lib


def reproduce_figures():
    """Figure 2 at 96 blocks; returns ``{machine: {impl: ops/s}}``."""
    print("\n== paper Figure 2 (mutex, 96 blocks):")
    out = {}
    for machine in (TESLA, FERMI):
        row = {}
        for impl in ("spin", "spin_backoff", "fa"):
            r = run_primitive(machine, "mutex", impl, blocks=96, ops=10,
                              max_events=6_000_000)
            row[impl] = r.ops_per_sec
        best = max(row, key=row.get)
        print(f"  {machine.name:14s} " +
              "  ".join(f"{k}={v:,.0f}" for k, v in row.items()) +
              f"  -> best: {best}")
        out[machine.name] = row
    return out


def cross_backend_check(lib, device=None):
    """One semaphore trace planned on every backend of ``device``;
    returns ``{backend: agrees with ref}``."""
    backends = (("host", "cuda", "ref")
                if resolve_device(device).type == "cuda" else ("host", "ref"))
    print(f"\n== one trace, {len(backends)} backends "
          f"({' / '.join(backends)})")
    rng = np.random.default_rng(0)
    arrivals = np.sort(rng.uniform(0, 3, 10)).astype(np.float32)
    holds = rng.uniform(1, 3, 10).astype(np.float32)
    plans = {be: lib.plan_semaphore(arrivals, holds, capacity=3, backend=be)
             for be in backends}
    ref = plans["ref"]
    agree = {}
    for be, p in plans.items():
        agree[be] = bool(np.array_equal(p.grant_order, ref.grant_order)
                         and np.allclose(p.release, ref.release, atol=1e-5))
        print(f"  semaphore[{be:6s}] grant_order={p.grant_order.tolist()} "
              f"queued={int(p.waited.sum())} "
              f"{'== ref' if agree[be] else '!= ref  <-- BUG'}")
    return agree


def control_plane_demo(lib, device=None):
    """The straggler detection and the admission plan; returns
    ``(rank 0's barrier outcome, the view after the eviction, the
    admission plan)``."""
    print("\n== control plane: straggler detection via XF barrier timeout")
    coord = ClusterCoordinator(world=4, barrier_timeout_s=0.5)
    seen = {}

    def healthy(rank):
        coord.heartbeat(rank, 1)
        out = coord.step_barrier(rank)
        if rank == 0:
            seen["outcome"] = out
            if not out.ok:
                print(f"  rank 0 saw stragglers: {out.stragglers} "
                      f"after {out.wait_s:.2f}s")

    threads = [threading.Thread(target=healthy, args=(r,)) for r in (0, 1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a rank never returned"
    view = coord.evict(3)
    print(f"  evicted rank 3 -> membership epoch {view.epoch}, "
          f"alive {view.alive}")

    print("\n== serving admission (paper Algorithm 5 as planning kernel)")
    arrivals = np.sort(np.random.default_rng(0).uniform(0, 5, 24)
                       ).astype(np.float32)
    service = np.random.default_rng(1).uniform(1, 3, 24).astype(np.float32)
    plan = plan_admission(arrivals, service, capacity=6, lib=lib,
                          device=device)
    print(f"  24 requests, capacity 6 [{plan.backend}]: "
          f"p50 wait {plan.p50_wait:.2f}s, "
          f"p99 {plan.p99_wait:.2f}s, makespan {plan.makespan:.1f}s, "
          f"queued {int(plan.waited.sum())}")
    return seen.get("outcome"), view, plan


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    host_lib = classify_machines()
    figure2 = reproduce_figures()
    agree = cross_backend_check(host_lib, device)
    outcome, view, plan = control_plane_demo(host_lib, device)
    assert all(agree.values()), agree
    print("\nsync_primitives demo done.")
    return {"host_lib": host_lib, "figure2": figure2, "agree": agree,
            "barrier": outcome, "view": view, "admission": plan}


if __name__ == "__main__":
    main()
