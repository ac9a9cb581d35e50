"""Host milliseconds per round in the engine's dispatch: the change of
``engine.stats()["span_dispatch_s"]`` (building the round's inputs and
launching its work, host syncs inside included) over the window, per
round that ended in it."""

KEY = "span_dispatch_s"


def read(ctx):
    run = ctx.run
    n = len(run.rounds.in_window(run.t_open, run.t_close))
    if not n or KEY not in run.stats_open or KEY not in run.stats_close:
        return None
    return 1e3 * (run.stats_close[KEY] - run.stats_open[KEY]) / n
