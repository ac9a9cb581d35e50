"""Median, over every request due in the window, from the time it was
due to its first token. A request shed, failed or still without a token
when the harness stopped waiting counts at that wait (and in
``failed``)."""

from bench.stats import percentile


def read(ctx):
    run = ctx.run
    due = [r for r in run.recs
           if run.t_open <= r.due < run.t_open + run.seconds]
    ttft = [(r.times[0] if r.times else ctx.t_stopped) - r.due for r in due]
    return 1e3 * percentile(ttft, 50) if ttft else None
