"""Acquires of the KV allocator's lock in the window
(``engine.stats()["lock_acquires"]``) per output token delivered in it."""

from bench.stats import window_tokens


def read(ctx):
    run = ctx.run
    n = window_tokens(run)
    if not n or "lock_acquires" not in run.stats_close:
        return None
    return (run.stats_close["lock_acquires"]
            - run.stats_open["lock_acquires"]) / n
