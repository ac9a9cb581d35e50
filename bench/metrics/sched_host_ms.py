"""Host milliseconds per round in the engine's scheduling phases: the
change of ``span_prep_s`` + ``span_post_s`` (``engine.stats()``: from
the round's start to its dispatch, and from its tokens' arrival to its
end) over the window, per round that ended in it. The device has nothing
queued in those phases: each round ends in a copy of its tokens to the
host."""

KEYS = ("span_prep_s", "span_post_s")


def read(ctx):
    run = ctx.run
    n = len(run.rounds.in_window(run.t_open, run.t_close))
    if not n or any(k not in run.stats_open or k not in run.stats_close
                    for k in KEYS):
        return None
    return 1e3 * sum(run.stats_close[k] - run.stats_open[k]
                     for k in KEYS) / n
