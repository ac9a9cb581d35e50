"""Prompt tokens prefilled in the window over the chunk lanes the device
computed for them: the changes of ``engine.stats()["prefill_tokens"]``
and ``["prefill_lanes_computed"]`` (every dispatched row's lanes of a
round that runs a prefill chunk, bucket rows that prefill nothing
included)."""

KEYS = ("prefill_tokens", "prefill_lanes_computed")


def read(ctx):
    run = ctx.run
    if any(k not in run.stats_open or k not in run.stats_close
           for k in KEYS):
        return None
    tokens, lanes = (run.stats_close[k] - run.stats_open[k] for k in KEYS)
    return 100.0 * tokens / lanes if lanes > 0 else None
