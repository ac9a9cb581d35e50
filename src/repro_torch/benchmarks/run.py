"""Benchmark entry point — one section per paper table/figure + system
rows.

Counterpart of ``benchmarks/run.py``, with the sections the port has.
Prints ``name,us_per_call,derived`` CSV lines:

  membench_*        paper Tables 1-3 (simulated Tesla/Fermi + the
                    measured host row; ``membench``)
  fig1/2/3_*        paper Figures 1-3 (primitive ops/s vs concurrency,
                    simulated), ``table5_*`` the auto-selection vs the
                    paper's Table 5, ``headline_*`` the Section-7
                    headline speedups, ``sync_*`` the sync library's
                    plan latency per backend (``primitives``)
  host_*            real-thread host-row sweeps (``hostbench``)
  kernel_*          every CUDA kernel against its plain version
                    (``kernels``; ``us_per_call`` is ``nan`` off the card)
  roofline*         the dry run's three-term roofline table on the H100
                    constants (``roofline``; reads the records
                    ``launch/dryrun.py`` wrote to ``$DRYRUN_ART``)

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] \\
        [--section NAME] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def kernel_rows(device=None) -> List[str]:
    """The kernel records as CSV lines (``nan`` where no device time was
    taken, i.e. off the card)."""
    from repro_torch.benchmarks import kernelbench
    rows = []
    for r in kernelbench.records(device):
        us = "nan" if r["ms"] is None else f"{r['ms'] * 1e3:.1f}"
        extra = ";fifo=1" if r.get("fifo") else ""
        rows.append(f"{r['name']},{us},match={int(bool(r['match']))}{extra}")
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller sweeps (CI mode)")
    ap.add_argument("--section", default=None,
                    choices=("membench", "primitives", "hostbench",
                             "kernels", "roofline"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, for the primitives and "
                         "kernels sections")
    args = ap.parse_args(argv)

    t_start = time.time()
    sections = []
    if args.section in (None, "membench"):
        from repro_torch.benchmarks import membench
        sections.append(("membench", membench.main))
    if args.section in (None, "primitives"):
        from repro_torch.benchmarks import primitives
        sections.append(("primitives", lambda: primitives.main(
            fast=args.fast, device=args.device)))
    if args.section in (None, "hostbench"):
        from repro_torch.benchmarks import hostbench
        sections.append(("hostbench", lambda: hostbench.main(
            threads=4 if args.fast else 8, ops=100 if args.fast else 300)))
    if args.section in (None, "kernels"):
        sections.append(("kernels", lambda: kernel_rows(args.device)))
    if args.section in (None, "roofline"):
        from repro_torch.benchmarks import roofline_report
        sections.append(("roofline", roofline_report.main))

    print("name,us_per_call,derived")
    for name, fn in sections:
        t0 = time.time()
        for row in fn():
            print(row)
        print(f"# section {name} took {time.time() - t0:.1f}s",
              file=sys.stderr)
    print(f"# total {time.time() - t_start:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
