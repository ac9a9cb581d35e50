"""Output tokens delivered in the window, over the window's seconds."""

from bench.stats import window_tokens


def read(ctx):
    run = ctx.run
    return window_tokens(run) / (run.t_close - run.t_open)
