"""Prompt tokens the engine skipped by adopting a shared or cached
prefix (the change in ``prefill_tokens_saved``, which counts an adoption
whichever index matched it) over the prompt tokens of the requests
granted between the same two rounds."""


def read(ctx):
    run = ctx.run
    o, c = run.extra.get("open_round"), run.extra.get("close_round")
    if o is None or c is None:
        return None
    a, b = run.rounds.t1[o], run.rounds.t1[c]
    tokens = sum(int(r.spec.prompt.size) for r in run.recs
                 if r.engine_req() is not None
                 and r.engine_req().grant_step >= 0
                 and a < r.engine_req().grant_s <= b)
    if not tokens:
        return None
    saved = (run.stats_close["prefill_tokens_saved"]
             - run.stats_open["prefill_tokens_saved"])
    return 100.0 * saved / tokens
