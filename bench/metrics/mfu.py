"""Useful model operations in the window over the window's seconds at
the H100's bf16 peak: prompt positions prefilled and tokens decoded, at
2 x the active weights each, plus attention over each position's live
context (``bench/flops.py``). Pad lanes, and lanes of rows that were
not prefilling, count nothing."""

from bench.flops import PEAK_FLOPS


def read(ctx):
    run = ctx.run
    idx = run.rounds.in_window(run.t_open, run.t_close)
    if not run.round_flops or not idx:
        return None
    ops = sum(run.round_flops.get(i, 0.0) for i in idx)
    return 100.0 * ops / ((run.t_close - run.t_open) * PEAK_FLOPS)
