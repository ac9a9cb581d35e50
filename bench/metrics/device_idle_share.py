"""Share of the traced rounds' time in which no kernel, copy or memset
ran on the device (read as ``device_idle_share.closed`` and
``device_idle_share.open``)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
