"""The sync library's primitives: Table-5 auto-selection and the plan
latency of every primitive on every backend.

Counterpart of the sync-library part of ``benchmarks/primitives.py``
(``table5_check``, ``backend_latency_rows``, ``smoke``); the simulator
sweeps of the paper's Figures 1-3 are not ported yet.

* :func:`table5_check` — ``select_impl`` on the paper's Tesla and Fermi
  abstractions against the paper's Table 5.
* :func:`backend_latency_rows` — ``plan_semaphore``, ``plan_mutex`` and
  ``plan_barrier`` through ``SyncLibrary`` on the backends ``host``
  (observed execution on real threads, the equivalence oracle), ``cuda``
  (the CUDA kernels) and ``ref`` (their plain versions): the median
  latency of a whole planning call on the host clock, device-to-host
  copy included — what a scheduler pays per replanning round.

    python -m repro_torch.benchmarks.primitives             # on cuda
    python -m repro_torch.benchmarks.primitives --device cpu
    python -m repro_torch.benchmarks.primitives --out primitives.json

On ``--device cpu`` the ``cuda`` backend is left out. It prints its rows
and writes the JSON summary only when given ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.abstraction import (FERMI, TESLA, PrimitiveKind,
                                          classify, select_impl)
from repro_torch.core.device import resolve_device


def table5_check() -> List[str]:
    """Auto-selection (select_impl) vs the paper's Table 5."""
    rows: List[str] = []
    expected = {
        ("tesla", "barrier"): "xf",
        ("fermi", "barrier"): "xf",
        ("tesla", "mutex"): "fa",
        ("fermi", "mutex"): "spin_backoff",
        ("tesla", "sem_low"): "sleeping",
        ("fermi", "sem_low"): "spin_backoff",
        ("tesla", "sem_high"): "sleeping",
        ("fermi", "sem_high"): "sleeping",
    }
    t0 = time.perf_counter()
    got = {
        ("tesla", "barrier"): select_impl(TESLA, PrimitiveKind.BARRIER).algorithm,
        ("fermi", "barrier"): select_impl(FERMI, PrimitiveKind.BARRIER).algorithm,
        ("tesla", "mutex"): select_impl(TESLA, PrimitiveKind.MUTEX).algorithm,
        ("fermi", "mutex"): select_impl(FERMI, PrimitiveKind.MUTEX).algorithm,
        ("tesla", "sem_low"): select_impl(
            TESLA, PrimitiveKind.SEMAPHORE, semaphore_initial=1).algorithm,
        ("fermi", "sem_low"): select_impl(
            FERMI, PrimitiveKind.SEMAPHORE, semaphore_initial=1).algorithm,
        ("tesla", "sem_high"): select_impl(
            TESLA, PrimitiveKind.SEMAPHORE, semaphore_initial=120).algorithm,
        ("fermi", "sem_high"): select_impl(
            FERMI, PrimitiveKind.SEMAPHORE, semaphore_initial=120).algorithm,
    }
    us = (time.perf_counter() - t0) * 1e6
    n_match = sum(got[k] == expected[k] for k in expected)
    detail = ";".join(f"{k[0]}.{k[1]}={got[k]}" +
                      ("" if got[k] == expected[k] else f"(paper:{expected[k]})")
                      for k in expected)
    rows.append(f"table5_selection,{us:.1f},match={n_match}/8;{detail}")
    rows.append(f"table5_classes,{0.0:.1f},"
                f"tesla={classify(TESLA)};fermi={classify(FERMI)}")
    return rows


def backend_latency_rows(
    *, n: int = 12, capacity: int = 3, repeats: int = 3,
    backends: Tuple[str, ...] = ("host", "cuda", "ref"),
) -> Tuple[List[str], Dict[str, Dict[str, float]]]:
    """Per-primitive per-backend plan latency of the sync library, in
    microseconds on the host clock (median of ``repeats`` after one
    warm-up call)."""
    from repro_torch.sync import SyncLibrary
    lib = SyncLibrary.host_default()
    rng = np.random.default_rng(0)
    arrivals = np.sort(rng.uniform(0, 3, n)).astype(np.float32)
    holds = rng.uniform(1, 3, n).astype(np.float32)
    arrival_perm = rng.permutation(n).astype(np.int32)
    present = np.ones(n, np.int64)

    plans = {
        "semaphore": lambda be: lib.plan_semaphore(
            arrivals, holds, capacity, backend=be),
        "mutex": lambda be: lib.plan_mutex(arrival_perm, backend=be),
        "barrier": lambda be: lib.plan_barrier(
            present, epoch=1, backend=be),
    }
    rows: List[str] = []
    data: Dict[str, Dict[str, float]] = {}
    for prim, plan in plans.items():
        data[prim] = {}
        for be in backends:
            plan(be)  # warm (builds the kernel on first use)
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                plan(be)
                times.append((time.perf_counter() - t0) * 1e6)
            us = float(np.median(times))
            data[prim][be] = us
            rows.append(f"sync_{prim}_{be},{us:.1f},n={n};plan_latency")
    return rows, data


def smoke(device=None) -> Tuple[List[str], dict]:
    """Backend latencies + the selection check: the rows and the JSON
    summary. ``cuda`` joins the backends unless ``device`` is ``cpu``."""
    dev = resolve_device(device)
    backends = ("host", "cuda", "ref") if dev.type == "cuda" \
        else ("host", "ref")
    rows, latency = backend_latency_rows(backends=backends)
    t5 = table5_check()
    rows += t5
    blob = {
        "device": dev.type,
        "backends_plan_latency_us": latency,
        "table5": t5[0].split(",", 2)[2],
        "machine_classes": t5[1].split(",", 2)[2],
    }
    return rows, blob


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (host and ref backends)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON summary to this file")
    args = ap.parse_args(argv)
    rows, blob = smoke(args.device)
    for r in rows:
        print(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(blob, f, indent=2)
    return blob


if __name__ == "__main__":
    main()
