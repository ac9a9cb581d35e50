"""Share of the window's rounds in which the engine's
``prefill_chunks`` counter advanced."""


def read(ctx):
    run = ctx.run
    idx = [i for i in run.rounds.in_window(run.t_open, run.t_close) if i]
    if not idx:
        return None
    c = run.rounds.chunks
    return 100.0 * sum(1 for i in idx if c[i] > c[i - 1]) / len(idx)
