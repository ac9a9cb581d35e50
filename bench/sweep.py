"""Find an open-loop cell's knee: the highest offered rate at which the
queue does not grow over a window.

    python3 -m bench.sweep --workload <name> --rates 2,3,4,5 \\
        [--seconds 30] [--seed 1]

One process: the weights, the engine and the documents are set up once;
then each rate runs the cell's traffic for a warm-up and a window, and
the live requests are cancelled before the next. Per rate one JSON line:
requests due in the window, the queue (requests submitted and not yet
granted) at the window's open and close and its least-squares slope over
the window, and TTFT p50 / p95 from the due time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from bench import spec
    from bench.run import _program_path, load

    cell = spec.load_cell(args.workload)
    _program_path(spec.ROOT)
    import torch

    from bench import drive, traffic
    from bench.stats import percentile

    dm, _, engine = load(cell, args.seed, torch.device(device), {})
    mix = cell.mix
    warm = float(mix["warm_s"])
    drive.serve_documents(engine, traffic.OpenTraffic(
        mix, dm["vocab"], args.seed, 1.0, 1.0).documents)
    drive.warm_shapes(engine, drive.bucket_sizes(engine.capacity),
                      engine.prefill_chunk + 1, dm["vocab"], args.seed)
    for rate in (float(r) for r in args.rates.split(",")):
        gen = traffic.OpenTraffic(mix, dm["vocab"], args.seed, rate,
                                  warm + args.seconds + 90.0)
        t = time.perf_counter()
        run = drive.run_open(engine, gen, warm, args.seconds,
                             int(mix["intake_limit"]), wait_s=20.0)
        pts = [(t_, d) for t_, d in run.extra["queue_depth"]
               if run.t_open <= t_ <= run.t_close]
        slope = (float(np.polyfit([p[0] for p in pts], [p[1] for p in pts],
                                  1)[0]) if len(pts) > 2 else None)
        due = [r for r in run.recs
               if run.t_open <= r.due < run.t_close]
        ttft = [(r.times[0] if r.times else time.perf_counter()) - r.due
                for r in due]
        print(json.dumps({
            "workload": cell.name, "rate_per_s": rate, "due": len(due),
            "queue_open": pts[0][1] if pts else None,
            "queue_close": pts[-1][1] if pts else None,
            "queue_slope_per_s": slope,
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p95_ms": 1e3 * percentile(ttft, 95),
            "without_token": sum(1 for r in due if not r.times),
            "rounds": len(run.rounds), "run_s": time.perf_counter() - t}))
        sys.stdout.flush()
    del engine
    if device == "cuda":
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
