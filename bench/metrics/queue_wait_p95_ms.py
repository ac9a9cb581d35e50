"""95th percentile of ``ServeRequest.wait_s`` (into the engine's queue
to the admission grant) over the requests granted in the window."""

from bench.stats import percentile


def read(ctx):
    run = ctx.run
    waits = []
    for r in run.recs:
        req = r.engine_req()
        if req is not None and req.grant_step >= 0 and (
                run.t_open < req.grant_s <= run.t_close):
            waits.append(req.wait_s)
    return 1e3 * percentile(waits, 95) if waits else None
