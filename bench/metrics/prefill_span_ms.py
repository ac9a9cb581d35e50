"""Device-clock milliseconds per prefill round from the first to the last
work of the prefill chunk, its unembedding included: the change of
``engine.stats()["span_prefill_device_s"]`` over the window, per round
in it whose ``prefill_chunks`` advanced (the rounds
``prefill_round_share`` counts)."""

KEY = "span_prefill_device_s"


def read(ctx):
    run = ctx.run
    if KEY not in run.stats_open or KEY not in run.stats_close:
        return None
    c = run.rounds.chunks
    n = sum(1 for i in run.rounds.in_window(run.t_open, run.t_close)
            if i and c[i] > c[i - 1])
    if not n:
        return None
    return 1e3 * (run.stats_close[KEY] - run.stats_open[KEY]) / n
