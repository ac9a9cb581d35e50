"""The retained prefix cache in the port, held to the JAX package on
identical inputs (the reference's tests/test_prefix_cache.py, case for
case, but for the cancelled donor, which waits for cancellation): the
same operation sequence, seeded with numpy, runs through the JAX
``PrefixCache`` over a JAX ``PagePool`` and through the port's, and
must agree —

* keys, donation (kept pages, duplicates), the split at a divergence
  page, lookups, LRU ``evict_plan`` groups and their freeable count,
  ``holders``, ``stats`` and the pools' refcounts;
* the atomic refusal of a double donation and of an eviction beyond the
  held references;
* ``SlotServeEngine`` with the cache on and off: greedy streams,
  ``grant_log``, allocator lock acquires and the cache statistics,
  exactly (two serves of one prompt, a two-turn conversation that
  adopts its generated reply, watermark eviction in a small arena, and
  acquires per round no higher with the cache than without).

Reduced qwen3-14b, float32, the reference's weights through the bridge;
threads are joined with a timeout and must have ended."""

import threading

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve import kv_pages as jkv
from repro.serve import prefix_cache as jpc
from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import kv_pages as tkv
from repro_torch.serve import prefix_cache as tpc
from repro_torch.serve.engine import SlotServeEngine

JOIN_S = 60.0
SFX = tpc.cache_key_suffix(0, 4)


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _toks(rng, n, vocab=64):
    return rng.integers(1, vocab, size=n).astype(np.int32)


def _norm(r):
    if isinstance(r, np.ndarray):
        return r.tolist()
    if isinstance(r, (list, tuple)):
        return type(r)(_norm(x) for x in r)
    return r


class _Pair:
    """A JAX pool + cache and the port's, driven by one operation at a
    time; every result, the caches' holders and stats and the pools'
    refcounts and free lists must agree after each."""

    def __init__(self, n, ps, **kw):
        self.pools = (jkv.PagePool(n, ps), tkv.PagePool(n, ps))
        self.caches = (jpc.PrefixCache(ps, self.pools[0], **kw),
                       tpc.PrefixCache(ps, self.pools[1], **kw))

    def __call__(self, fn):
        out = []
        for pool, cache in zip(self.pools, self.caches):
            try:
                r = fn(pool, cache)
            except Exception as e:      # noqa: BLE001 - compared below
                r = ("raised", type(e).__name__)
            out.append(_norm(r))
        assert out[0] == out[1]
        j, t = self.caches
        assert j.holders() == t.holders() and j.stats() == t.stats()
        assert (self.pools[0]._refcount.tolist(), list(self.pools[0]._free),
                self.pools[0].lock_stats()["acquires"]) == \
            (self.pools[1]._refcount.tolist(), list(self.pools[1]._free),
             self.pools[1].lock_stats()["acquires"])
        return out[1]

    def check(self):
        for pool, cache in zip(self.pools, self.caches):
            cache.check()
            pool.check()


# ================================================================ trie
def test_cache_key_suffix_matches_reference():
    pairs = [(0, 4), (0, 8), (16, 0), (32, 0), (2 ** 20, 7)]
    assert [tpc.cache_key_suffix(*p) for p in pairs] == \
        [jpc.cache_key_suffix(*p) for p in pairs]
    assert len({tpc.cache_key_suffix(*p) for p in pairs}) == 5


def test_donate_lookup_roundtrip():
    c = _Pair(16, 4)
    rng = np.random.default_rng(0)
    toks, tail, other = _toks(rng, 12), _toks(rng, 2), _toks(rng, 12)
    ids = c(lambda p, _: p.alloc(3, tag="donor"))
    kept, dup = c(lambda _, k: k.donate(toks, ids, SFX))
    assert kept == ids and dup == []
    assert c(lambda _, k: k.lookup(np.concatenate([toks, tail]), SFX)) == \
        (12, ids)
    assert c(lambda _, k: k.lookup(toks[:10], SFX)) == (8, ids[:2])
    assert c(lambda _, k: k.lookup(other, SFX)) == (0, None)
    assert c(lambda _, k: k.lookup(toks, tpc.cache_key_suffix(0, 8))) == \
        (0, None)
    c.check()
    c(lambda p, k: p.free_batch(k.drop_all()))
    assert c.pools[1].in_use == 0


def test_split_at_exact_divergence_page():
    c = _Pair(16, 4)
    rng = np.random.default_rng(1)
    head = _toks(rng, 4)
    a = np.concatenate([head, _toks(rng, 8)])
    b = np.concatenate([head, _toks(rng, 8)])
    ids_a = c(lambda p, _: p.alloc(3, tag="a"))
    c(lambda _, k: k.donate(a, ids_a, SFX))
    ids_b = c(lambda p, _: p.alloc(3, tag="b"))
    kept, dup = c(lambda _, k: k.donate(b, ids_b, SFX))
    assert dup == ids_b[:1] and kept == ids_b[1:]
    c(lambda p, _: p.free_batch([dup]))
    assert c(lambda _, k: k.lookup(a, SFX)) == (12, ids_a)
    assert c(lambda _, k: k.lookup(b, SFX)) == (12, [ids_a[0]] + ids_b[1:])
    c.check()
    c(lambda p, k: p.free_batch(k.drop_all()))
    assert c.pools[1].in_use == 0


def test_duplicate_donation_returns_all_as_dup():
    c = _Pair(16, 4)
    toks = _toks(np.random.default_rng(2), 8)
    first = c(lambda p, _: p.alloc(2, tag="first"))
    c(lambda _, k: k.donate(toks, first, SFX))
    second = c(lambda p, _: p.alloc(2, tag="second"))
    kept, dup = c(lambda _, k: k.donate(toks, second, SFX))
    assert kept == [] and dup == second
    c(lambda p, _: p.free_batch([dup]))
    assert c.caches[1].stats()["cache_pages_duplicate"] == 2.0
    assert c.pools[1].in_use == 2
    c(lambda p, k: p.free_batch(k.drop_all()))


def test_lru_eviction_trims_least_recent_leaf_tail_first():
    c = _Pair(32, 4)
    rng = np.random.default_rng(3)
    cold, hot = _toks(rng, 12), _toks(rng, 12)
    c(lambda p, k: k.donate(cold, p.alloc(3, tag="cold"), SFX))
    c(lambda p, k: k.donate(hot, p.alloc(3, tag="hot"), SFX))
    c(lambda _, k: k.lookup(hot, SFX))
    groups, freeable = c(lambda _, k: k.evict_plan(2))
    assert freeable == 2
    assert c(lambda _, k: k.lookup(cold, SFX))[0] == 4
    assert c(lambda _, k: k.lookup(hot, SFX))[0] == 12
    c(lambda p, _: p.free_batch(groups))
    c.check()
    assert c.pools[1].in_use == 6 - sum(len(g) for g in groups)
    c(lambda p, k: p.free_batch(k.drop_all()))


def test_evict_plan_only_counts_sole_references_as_freeable():
    c = _Pair(32, 4)
    rng = np.random.default_rng(4)
    shared, lone = _toks(rng, 8), _toks(rng, 8)
    sh_ids = c(lambda p, _: p.alloc(2, tag="shared"))
    c(lambda _, k: k.donate(shared, sh_ids, SFX))
    c(lambda p, _: p.incref_batch([sh_ids]))
    c(lambda _, k: k.lookup(shared, SFX))
    lone_ids = c(lambda p, _: p.alloc(2, tag="lone"))
    c(lambda _, k: k.donate(lone, lone_ids, SFX))
    c(lambda _, k: k.lookup(lone, SFX))
    c(lambda _, k: k.lookup(lone, SFX))
    groups, freeable = c(lambda _, k: k.evict_plan(2))
    assert freeable >= 2
    assert len(c(lambda p, _: p.free_batch(groups))) >= 2
    c(lambda p, k: p.free_batch(k.drop_all()))
    c(lambda p, _: p.free_batch([sh_ids]))
    assert c.pools[1].in_use == 0


def test_generated_pages_and_prompt_only_policy():
    toks = _toks(np.random.default_rng(5), 12)    # prompt 8, generated 4
    c = _Pair(16, 4)
    ids = c(lambda p, _: p.alloc(3, tag="conv"))
    c(lambda _, k: k.donate(toks, ids, SFX, generated_from=8))
    assert c(lambda _, k: k.lookup(toks, SFX))[0] == 12
    c(lambda p, k: p.free_batch(k.drop_all()))
    c = _Pair(16, 4, adopt_policy="prompt")
    ids = c(lambda p, _: p.alloc(3, tag="conv2"))
    c(lambda _, k: k.donate(toks, ids, SFX, generated_from=8))
    assert c(lambda _, k: k.lookup(toks, SFX)) == (8, ids[:2])
    again = c(lambda p, _: p.alloc(3, tag="re"))
    _, dup = c(lambda _, k: k.donate(toks, again, SFX))
    c(lambda p, _: p.free_batch([dup]))
    assert c(lambda _, k: k.lookup(toks, SFX))[0] == 12
    c(lambda p, k: p.free_batch(k.drop_all()))
    assert c.pools[1].in_use == 0


def test_double_donation_of_one_reference_raises_on_drain():
    c = _Pair(16, 4)
    rng = np.random.default_rng(6)
    a, b = _toks(rng, 8), _toks(rng, 8)
    ids = c(lambda p, _: p.alloc(2, tag="x"))
    c(lambda _, k: k.donate(a, ids, SFX))
    c(lambda _, k: k.donate(b, ids, SFX))        # same pages, new chain
    groups = c(lambda _, k: k.drop_all())
    assert c(lambda p, _: p.free_batch(groups)) == ("raised",
                                                    "PageLeakError")
    with pytest.raises(tkv.PageLeakError):
        c.pools[1].free_batch(groups)


def test_eviction_beyond_held_references_raises_atomically():
    c = _Pair(8, 4)
    ids = np.asarray(c(lambda p, _: p.alloc(2, tag="held")), np.int32)
    assert c(lambda p, _: p.alloc_batch(
        [1], ["grab"], decref_groups=[ids[:1], ids[:1]])) == (
        "raised", "PageLeakError")
    for pool, leak in zip(c.pools, (jkv.PageLeakError, tkv.PageLeakError)):
        with pytest.raises(leak, match="beyond its held"):
            pool.alloc_batch([1], ["grab"], decref_groups=[ids[:1], ids[:1]])
        assert pool.n_free == 6
    c(lambda p, _: p.free_batch([ids]))
    assert c(lambda p, _: p.alloc_batch(
        [0], ["noop"], decref_groups=[ids[:1]])) == ("raised",
                                                     "PageLeakError")
    c.check()


def test_eviction_rider_funds_the_grant_in_one_acquire():
    """An eviction decref rider frees pages before the batch's grants:
    a grant larger than the free list succeeds in one acquire."""
    c = _Pair(8, 4)
    toks = _toks(np.random.default_rng(14), 16)
    ids = c(lambda p, _: p.alloc(4, tag="donor"))
    c(lambda _, k: k.donate(toks, ids, SFX))
    groups, freeable = c(lambda _, k: k.evict_plan(3))
    assert freeable == 3
    got = c(lambda p, _: p.alloc_batch([7], ["big"], decref_groups=groups))
    assert len(got[0]) == 7
    c.check()


def test_external_holder_registration_feeds_pool_check(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(7)
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=32, kv_layout="paged",
                          page_size=4, prefix_cache="on",
                          prefill_chunk_tokens=4, device="cpu")
    eng.submit(_toks(rng, 9, tm.cfg.vocab_size), 4)
    eng.run_until_done(max_rounds=100)
    assert eng.prefix_cache.pages_held > 0
    eng.pool.check()
    eng.pool.register_external_holder(lambda: {0: 1})
    with pytest.raises(AssertionError):
        eng.pool.check()


# ================================================ engines, cache on/off
def _engine(cls, model, params, extra, **kw):
    args = dict(capacity=2, max_len=48, kv_layout="paged", page_size=4,
                prefill_chunk_tokens=4, decode_chunk=2)
    args.update(kw)
    return cls(model, params, **args, **extra)


def _record(eng, handles, rounds=None):
    st = eng.stats()
    eng.pool.check()
    return {"streams": [list(h.out_tokens) for h in handles],
            "grant_log": list(eng.grant_log),
            "acquires": eng.pool.pages.lock_stats()["acquires"],
            "rounds": rounds,
            **{k: v for k, v in st.items()
               if k.startswith("cache_") or k in (
                   "prefix_cache", "prefix_hits", "shared_pages_adopted",
                   "cow_splits", "prefill_tokens", "prefill_tokens_saved",
                   "pages_alloced", "page_increfs", "page_decrefs",
                   "page_pauses", "page_preemptions")}}


def _both_engines(models, drive, **kw):
    jm, jp, tm, tp = models
    want = drive(_engine(JEngine, jm, jp, {"seed": 0}, **kw))
    got = drive(_engine(SlotServeEngine, tm, tp, {"device": "cpu"}, **kw))
    assert got == want
    return got


def _serve_twice(prompt):
    def drive(eng):
        r1 = eng.submit(prompt, 6)
        eng.run_until_done(max_rounds=200)
        r2 = eng.submit(prompt.copy(), 6)
        eng.run_until_done(max_rounds=200)
        out = _record(eng, [r1, r2])
        eng.drop_prefix_cache()
        eng.pool.check()
        out["in_use_after_drop"] = eng.pool.pages.in_use
        return out
    return drive


def test_characterization_without_cache_prefill_reruns(models):
    prompt = _toks(np.random.default_rng(8), 13, models[2].cfg.vocab_size)
    got = _both_engines(models, _serve_twice(prompt), prefix_cache="off")
    assert got["streams"][0] == got["streams"][1]
    assert got["prefix_cache"] == 0.0 and got["cache_hits"] == 0.0
    assert got["prefill_tokens_saved"] == 0.0
    assert got["pages_alloced"] >= 2 * 4 and got["in_use_after_drop"] == 0


@pytest.mark.parametrize("prefill_chunk", [4, None],
                         ids=["chunked", "one-shot"])
def test_characterization_with_cache_prefill_skipped(models, prefill_chunk):
    """Cache on: retirement donates, the re-submission adopts the
    retained prefix (chunked: its chunks are skipped), streams equal
    the cache-off run's, and dropping the cache empties the arena. (One
    shot, the live index's partial-tail entry, valid because the cache
    holds its page, is longer than the cache's full pages and wins the
    attribution, as in the reference.)"""
    prompt = _toks(np.random.default_rng(8), 13, models[2].cfg.vocab_size)
    off = _both_engines(models, _serve_twice(prompt), prefix_cache="off",
                        prefill_chunk_tokens=prefill_chunk)
    on = _both_engines(models, _serve_twice(prompt), prefix_cache="on",
                       prefill_chunk_tokens=prefill_chunk)
    assert on["streams"] == off["streams"]
    assert on["prefix_cache"] == 1.0 and on["cache_lookup_hits"] >= 1.0
    assert on["prefix_hits"] >= 1.0 and on["cache_hit_rate"] > 0.0
    assert on["in_use_after_drop"] == 0
    if prefill_chunk:
        assert on["prefill_tokens_saved"] > 0.0


def test_multi_turn_conversation_reuses_generated_prefix(models):
    cfg = models[2].cfg
    rng = np.random.default_rng(9)
    turn1, follow = _toks(rng, 9, cfg.vocab_size), _toks(rng, 5,
                                                         cfg.vocab_size)

    def drive(eng):
        r1 = eng.submit(turn1, 7)
        eng.run_until_done(max_rounds=300)
        r2 = eng.submit(np.concatenate(
            [turn1, np.asarray(r1.out_tokens, np.int32), follow]), 5)
        eng.run_until_done(max_rounds=300)
        out = _record(eng, [r1, r2])
        eng.drop_prefix_cache()
        out["in_use_after_drop"] = eng.pool.pages.in_use
        return out
    outs = {mode: _both_engines(models, drive, max_len=64, prefix_cache=mode)
            for mode in ("off", "on")}
    assert outs["on"]["streams"] == outs["off"]["streams"]
    on = outs["on"]
    assert on["cache_hits"] >= 1.0 and on["prefill_tokens_saved"] > 0.0
    assert on["cache_tokens_served"] > (turn1.size // 4) * 4 - 4
    assert on["in_use_after_drop"] == 0


@pytest.mark.parametrize("prefill_chunk", [4, None],
                         ids=["chunked", "one-shot"])
def test_watermark_eviction_under_page_pressure(models, prefill_chunk):
    rng = np.random.default_rng(11)
    prompts = [_toks(rng, 11, models[2].cfg.vocab_size) for _ in range(5)]

    def drive(eng):
        hs = [eng.submit(p, 4) for p in prompts]
        eng.run_until_done(max_rounds=500)
        assert len(eng.finished) == 5
        out = _record(eng, hs)
        eng.drop_prefix_cache()
        out["in_use_after_drop"] = eng.pool.pages.in_use
        return out
    got = _both_engines(models, drive, max_len=32, num_pages=14,
                        prefix_cache="on", prefill_chunk_tokens=prefill_chunk)
    assert got["cache_pages_evicted"] > 0.0
    assert got["in_use_after_drop"] == 0


def test_lock_acquires_per_round_unchanged_with_cache(models):
    rng = np.random.default_rng(12)
    prompts = [_toks(rng, 9 + 2 * i, models[2].cfg.vocab_size)
               for i in range(4)]

    def drive(eng):
        hs = [eng.submit(p, 5) for p in prompts]
        rounds = eng.run_until_done(max_rounds=500)
        out = _record(eng, hs, rounds)
        eng.drop_prefix_cache()
        assert eng.pool.pages.in_use == 0
        return out
    per_round = {}
    for mode in ("off", "on"):
        got = _both_engines(models, drive, prefix_cache=mode)
        per_round[mode] = got["acquires"] / max(got["rounds"], 1)
    assert per_round["on"] <= per_round["off"] + 1e-9, per_round


def test_threaded_donation_eviction_churn_is_leak_free():
    """Donors, an adopter and an evictor hammer each pool + cache from
    threads; every thread ends, and every reference is accounted for:
    both drain to an empty arena and pass their checks."""
    streams = [_toks(np.random.default_rng(100 + i), 12) for i in range(6)]
    for kv, pc in ((jkv, jpc), (tkv, tpc)):
        pool = kv.PagePool(64, 4)
        cache = pc.PrefixCache(4, pool)
        leak = kv.PageLeakError
        rng = np.random.default_rng(13)
        errors = []
        stop = threading.Event()

        def donor(i, pool=pool, cache=cache, errors=errors):
            try:
                for k in range(25):
                    toks = streams[(i + k) % len(streams)]
                    try:
                        ids = pool.alloc(3, tag=("don", i, k))
                    except Exception:
                        continue                 # arena momentarily full
                    kept, _ = cache.donate(toks, ids, SFX)
                    drop = ids[~np.isin(ids, kept)]
                    if drop.size:
                        pool.free_batch([drop])
            except Exception as e:               # pragma: no cover
                errors.append(e)

        def adopter(pool=pool, cache=cache, errors=errors, stop=stop,
                    rng=rng, leak=leak):
            try:
                while not stop.is_set():
                    s = streams[int(rng.integers(0, len(streams)))]
                    _, ids = cache.lookup(s, SFX)
                    if ids is not None:
                        try:
                            pool.incref_batch([ids])
                        except leak:
                            continue             # evicted meanwhile: refused
                        pool.free_batch([ids])
            except Exception as e:               # pragma: no cover
                errors.append(e)

        def evictor(pool=pool, cache=cache, errors=errors, stop=stop):
            try:
                while not stop.is_set():
                    groups, _ = cache.evict_plan(2)
                    if groups:
                        pool.free_batch(groups)
            except Exception as e:               # pragma: no cover
                errors.append(e)

        donors = [threading.Thread(target=donor, args=(i,), daemon=True)
                  for i in range(3)]
        others = [threading.Thread(target=adopter, daemon=True),
                  threading.Thread(target=evictor, daemon=True)]
        for t in donors + others:
            t.start()
        for t in donors:
            t.join(JOIN_S)
        stop.set()
        for t in others:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in donors + others), "a thread hung"
        assert not errors, errors
        cache.check()
        pool.check()
        pool.free_batch(cache.drop_all())
        assert pool.in_use == 0
