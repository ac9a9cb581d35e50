"""The traffic generator: deterministic for a seed, the stated
distributions, a closed loop that starts settled, the same sizes for
every seed with other data."""

import numpy as np

from bench import traffic
from bench.tests.tiny import ROOT

import json

CLOSED = json.loads((ROOT / "bench/mixes/reasoning-closed.json").read_text())
OPEN = json.loads((ROOT / "bench/mixes/rag-open.json").read_text())


def test_closed_is_deterministic_per_seed():
    a = traffic.ClosedTraffic(CLOSED, 1000, 2 ** 31 + 7)
    b = traffic.ClosedTraffic(CLOSED, 1000, 2 ** 31 + 7)
    for k in (0, 5, 200):
        ra, rb = a.request(k), b.request(k)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert ra.max_new_tokens == rb.max_new_tokens


def test_closed_draws_the_stated_uniforms():
    t = traffic.ClosedTraffic(CLOSED, 1000, 3)
    n = CLOSED["requests_pool"]
    lo, hi = CLOSED["prompt_tokens"]
    assert t.prompt_len.min() >= lo and t.prompt_len.max() <= hi
    assert abs(t.prompt_len.mean() - (lo + hi) / 2) < 1.0
    # every length of the range appears about n / (hi - lo + 1) times
    counts = np.bincount(t.prompt_len - lo, minlength=hi - lo + 1)
    assert counts.max() - counts.min() <= 1 + n // (hi - lo + 1)
    lo, hi = CLOSED["output_tokens"]
    assert t.out_len.min() >= lo and t.out_len.max() <= hi
    rest = t.out_len[t.live:]
    assert abs(rest.mean() - (lo + hi) / 2) < 0.01 * hi
    assert t.live == CLOSED["engine"]["capacity"]
    assert not t.age[t.live:].any()


def test_closed_starts_settled():
    """The live requests' lengths are length-biased and their ages
    uniform over each life: the residual (tokens left) has the settled
    loop's mean E[L^2] / (2 E[L]) + 1/2, and the window sees them
    complete evenly. A live request is submitted with its served tokens
    in its prompt and asks for the rest."""
    t = traffic.ClosedTraffic(CLOSED, 1000, 3)
    lo, hi = CLOSED["output_tokens"]
    n = t.live
    length, age = t.out_len[:n], t.age[:n]
    res = length - age
    assert (age >= 0).all() and (res >= 1).all()
    ls = np.arange(lo, hi + 1, dtype=np.float64)
    assert abs(length.mean() - (ls ** 2).sum() / ls.sum()) < 0.03 * hi
    want = (ls ** 2).mean() / (2 * ls.mean()) + 0.5
    assert abs(res.mean() - want) < 0.03 * want
    # stratified: one residual in each 1/n of the residual's law
    assert np.unique(res).size == n
    r = t.request(5)
    assert r.prompt.size == t.prompt_len[5] + age[5]
    assert r.max_new_tokens == res[5]
    # a long draw of the same law
    u = (np.arange(20000) + 0.5) / 20000
    big_l, big_a = traffic.settled_lives(
        lo, hi, u, np.random.default_rng(0).permutation(u))
    assert abs((big_l - big_a).mean() - want) < 0.005 * want
    assert abs(big_a.mean() - (ls ** 2).mean() / (2 * ls.mean()) + 0.5) \
        < 0.01 * want


def test_seeds_share_sizes_and_order_with_other_data():
    a = traffic.ClosedTraffic(CLOSED, 1000, 11)
    b = traffic.ClosedTraffic(CLOSED, 1000, 2 ** 31 + 12)
    assert np.array_equal(a.prompt_len, b.prompt_len)
    assert np.array_equal(a.out_len, b.out_len)
    assert np.array_equal(a.age, b.age)
    assert not np.array_equal(a.request(0).prompt[:8],
                              b.request(0).prompt[:8])
    o = traffic.OpenTraffic(OPEN, 1000, 11, 2.0, 100.0)
    p = traffic.OpenTraffic(OPEN, 1000, 12, 2.0, 100.0)
    assert np.array_equal(o.due_s, p.due_s) and np.array_equal(o.doc, p.doc)
    assert not np.array_equal(o.documents, p.documents)


def test_open_arrivals_documents_and_suffixes():
    rate, horizon = 4.0, 500.0
    t = traffic.OpenTraffic(OPEN, 5000, 9, rate, horizon)
    u = traffic.OpenTraffic(OPEN, 5000, 9, rate, horizon)
    assert np.array_equal(t.due_s, u.due_s) and np.array_equal(t.doc, u.doc)
    n = len(t)
    assert n == int(np.ceil(rate * horizon))
    gaps = np.diff(np.concatenate([[0.0], t.due_s]))
    assert abs(gaps.mean() - 1 / rate) < 0.02 / rate
    # exponential: the median gap is ln 2 / rate
    assert abs(np.median(gaps) - np.log(2) / rate) < 0.02 / rate
    lo, hi = OPEN["suffix_tokens"]
    assert t.suffix_len.min() >= lo and t.suffix_len.max() <= hi
    # Zipf: the most popular document is asked about most, and about
    # 1 / H(64, 1.1) of the time
    counts = np.bincount(t.doc, minlength=OPEN["documents"])
    w = np.arange(1, OPEN["documents"] + 1) ** -OPEN["zipf_s"]
    assert abs(counts.max() / n - w[0] / w.sum()) < 0.01
    ranked = np.sort(counts)[::-1]
    assert ranked[0] > ranked[8] > ranked[40]
    r = t.request(3)
    assert np.array_equal(r.prompt[:OPEN["document_tokens"]],
                          t.documents[t.doc[3]])
    assert r.prompt.size == OPEN["document_tokens"] + t.suffix_len[3]
    assert r.due_s == t.due_s[3]


def test_sample_holds_the_longest():
    lengths = [5, 90, 7, 3, 40]
    picked = traffic.sample_requests(lengths, 60, 1, 3)
    assert picked[0] == 1
    assert traffic.sample_requests(lengths, 60, 1, 3) == picked
    assert len(traffic.sample_requests(lengths, 10 ** 6, 1, 10)) == 5
