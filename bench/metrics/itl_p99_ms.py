"""99th percentile of every gap between two consecutive tokens of one
request, both delivered inside the window."""

from bench.stats import gaps_in, percentile


def read(ctx):
    run = ctx.run
    gaps = [g for r in run.recs for g in gaps_in(r.times, run.t_open,
                                                  run.t_close)]
    return 1e3 * percentile(gaps, 99) if gaps else None
