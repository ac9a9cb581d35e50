"""Readings that set a cell's output limit: the program's and the
control's, seed by seed, in one process.

    python3 -m bench.control --workload <name> --seeds 1,2,3 \\
        [--seconds <s>] [--control fp8]

Each seed is one run of the cell (``bench.run.run_cell``) at its own
load and sizes. After the window the same sample of finished requests
is read twice under the float32 reference: the program's served tokens
(``program_max_gap``, ``program_mean_gap``: the numbers a run compares)
and, standing in the program's place, at every position of the same
prompts and tokens the token the control puts first (``max_gap``,
``mean_gap``), judged against the cell's limits as a run judges the
program: ``correct`` has to come out false. The control is the
reference with every weight matmul's operands rounded to float8 e4m3,
the precision below the configured bfloat16. The benchmark's own runs
never run it. One JSON line per seed goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench import spec
from bench.run import run_cell


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control", default="fp8")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seconds = args.seconds or cell.run_seconds
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        res = run_cell(cell, s, seconds, False, device=device,
                       t_start=time.perf_counter(), control=args.control)
        c = res["checks"]
        print(json.dumps({"workload": cell.name, "seed": s,
                          **{"program_" + k: v
                             for k, v in res["program"].items()},
                          **{k: c[k]["value"] for k in c},
                          "correct": res["correct"],
                          "metrics": res["metrics"],
                          "run_s": time.perf_counter() - t}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
