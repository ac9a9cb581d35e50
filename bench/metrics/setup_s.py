"""Process start to window open: imports, kernel load, weights, warm-up
and the ramp the traffic needs."""


def read(ctx):
    return ctx.setup_s
