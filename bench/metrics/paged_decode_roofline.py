"""The paged decode kernel's share of its memory roofline over the
traced rounds: the bytes the live lengths of its launches need (K and V
of each position read, the query and the output; ``bench/flops.py``) at
3.35 TB/s, over the summed device time of ``paged_decode`` kernels."""

from bench.flops import HBM_BW, decode_bytes


def read(ctx):
    run, tr = ctx.run, ctx.trace
    if tr is None or not run.decode_lengths:
        return None
    t = tr.kernel_time("paged_decode")
    lo, hi = run.rounds.profiled
    lens = [run.decode_lengths.get(i) for i in range(lo, hi)]
    if t <= 0 or any(x is None for x in lens):
        return None
    need = sum(decode_bytes(ctx.dm, x) for x in lens)
    return 100.0 * (need / HBM_BW) / t
