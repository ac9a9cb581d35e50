"""Window statistics: percentiles and rates over every sample of the
window, so a stall inside it moves them."""

import math
import types

from bench import stats
from bench.drive import Rec, Rounds, Run
from bench.run import read_metric
from bench.tests.tiny import ROOT
from bench.traffic import Request

import numpy as np


def test_percentile_matches_numpy_and_handles_inf():
    vals = [5.0, 1.0, 3.0, 9.0, 7.0, 2.0]
    for q in (0, 50, 95, 100):
        assert math.isclose(stats.percentile(vals, q),
                            float(np.percentile(vals, q)))
    assert stats.percentile(vals + [math.inf], 50) == 5.0
    assert stats.percentile([1.0, math.inf], 95) == math.inf
    assert math.isnan(stats.percentile([], 95))


def _run(stall_at=None, stall=1.0):
    """Two requests, one token per 50 ms round for 10 s; with a stall,
    every round from ``stall_at`` on comes ``stall`` seconds later."""
    rounds = Rounds(types.SimpleNamespace(step=lambda: 0, prefill_chunks=0))
    t = 0.0
    recs = [Rec(Request(i, np.zeros(4, np.int32), 400), due=0.0)
            for i in range(2)]
    for k in range(200):
        t0 = t
        t += 0.05 + (stall if stall_at is not None and k == stall_at else 0)
        rounds.t0.append(t0)
        rounds.t1.append(t)
        rounds.chunks.append(0)
        for r in recs:
            r.times.append(t)
    return Run("closed", recs, rounds, t_open=0.0, t_close=t, seconds=t,
               stats_open={}, stats_close={})


def _read(name, run):
    ctx = types.SimpleNamespace(run=run, trace=None, dm={}, setup_s=1.0,
                                t_stopped=run.t_close)
    return read_metric(ROOT, name, ctx)


def test_rates_and_tails_cover_the_whole_window():
    base = _run()
    assert math.isclose(_read("output_tokens_per_s", base), 2 / 0.05)
    assert math.isclose(_read("itl_p99_ms", base), 50.0)
    assert math.isclose(_read("round_ms", base), 50.0)
    # one 1 s stall in 200 rounds: the rate falls by its share of the
    # window, and the round mean and gap tail see it
    st = _run(stall_at=100, stall=1.0)
    assert math.isclose(_read("output_tokens_per_s", st), 400 / 11.0)
    assert _read("round_ms", st) > 54.9
    # nineteen stalls (9.5 % of the gaps) reach the 99th percentile
    many = _run()
    for k in range(10, 200, 10):
        many.rounds.t1[k:] = [x + 0.5 for x in many.rounds.t1[k:]]
        for r in many.recs:
            r.times[k:] = [x + 0.5 for x in r.times[k:]]
    many.t_close = many.rounds.t1[-1]
    assert _read("itl_p99_ms", many) > 100.0


def test_gaps_need_both_tokens_inside():
    times = [0.5, 1.0, 1.5, 2.0, 2.5]
    assert stats.gaps_in(times, 0.9, 2.0) == [0.5, 0.5]
    assert stats.tokens_in(times, 0.9, 2.0) == 3
