"""Benchmark entry point — one section per paper table + system rows.

Counterpart of ``benchmarks/run.py``, with the sections the port has.
Prints ``name,us_per_call,derived`` CSV lines:

  table5_*, sync_*  auto-selection vs the paper's Table 5, and the sync
                    library's plan latency per backend (``primitives``)
  host_*            real-thread host-row sweeps (``hostbench``)
  kernel_*          every CUDA kernel against its plain version
                    (``kernels``; ``us_per_call`` is ``nan`` off the card)

Not ported yet, so not offered: ``membench`` (the simulated Tables 1-3
and the host row) and ``roofline`` (the dry-run roofline table), nor the
simulator sweeps and headline speedups of the reference's
``primitives`` section.

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
                    choices=("primitives", "hostbench", "kernels"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, for the primitives and "
                         "kernels sections")
    args = ap.parse_args(argv)

    t_start = time.time()
    sections = []
    if args.section in (None, "primitives"):
        from repro_torch.benchmarks import primitives
        sections.append(("primitives",
                         lambda: primitives.smoke(args.device)[0]))
    if args.section in (None, "hostbench"):
        from repro_torch.benchmarks import hostbench
        sections.append(("hostbench", lambda: hostbench.main(
            threads=4 if args.fast else 8, ops=100 if args.fast else 300)))
    if args.section in (None, "kernels"):
        sections.append(("kernels", lambda: kernel_rows(args.device)))

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
