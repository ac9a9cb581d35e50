"""Mean of the harness's span around every ``engine.step`` that ended in
the window."""


def read(ctx):
    run = ctx.run
    idx = run.rounds.in_window(run.t_open, run.t_close)
    if not idx:
        return None
    r = run.rounds
    return 1e3 * sum(r.t1[i] - r.t0[i] for i in idx) / len(idx)
