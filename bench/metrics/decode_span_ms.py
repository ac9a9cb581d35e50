"""Device-clock milliseconds per round from the first to the last work of
the decode scan: the change of ``engine.stats()["span_decode_device_s"]``
over the window, per round that ended in it. A span, not busy time: it
includes the gaps in which the device waits for the host's launches."""

KEY = "span_decode_device_s"


def read(ctx):
    run = ctx.run
    n = len(run.rounds.in_window(run.t_open, run.t_close))
    if not n or KEY not in run.stats_open or KEY not in run.stats_close:
        return None
    return 1e3 * (run.stats_close[KEY] - run.stats_open[KEY]) / n
