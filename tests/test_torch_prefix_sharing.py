"""Copy-on-write prefix sharing in the port, held to the JAX package on
identical inputs (the reference's tests/test_prefix_sharing.py, case for
case): the same operation sequence, seeded with numpy, runs through the
JAX object and its port, and the results must be equal —

* ``PagePool`` refcounts, epochs, free lists, counters and rider
  outcomes (``incref_groups``, ``paired_decrefs``), and the atomic
  refusal of a refcount violation;
* ``PrefixIndex`` lookups (longest match, exact-length partial tail,
  bucket and schedule keys, stale pruning) and its raw keys;
* ``PagedSlotPool`` splits (``shared_write_targets``, ``prepare_batch``,
  the copy) and ``attention.copy_pages``, at tolerance 0;
* ``SlotServeEngine`` greedy streams, ``grant_log``, allocator lock
  acquires and the sharing statistics, exactly, with one-shot and
  chunked prefill, sharing on and off (the port's on and off streams
  are equal too).

Reduced qwen3-14b, float32, the reference's weights through the bridge;
threads are joined with a timeout and must have ended."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serve import kv_pages as jkv
from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import kv_pages as tkv
from repro_torch.serve.engine import SlotServeEngine

JOIN_S = 60.0


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _pools(n, ps):
    return jkv.PagePool(n, ps), tkv.PagePool(n, ps)


def _state(pool):
    return (list(pool._free), pool._allocated.tolist(),
            pool._refcount.tolist(), pool._epoch.tolist(), pool.allocs,
            pool.frees, pool.pages_alloced, pool.pages_freed, pool.increfs,
            pool.decrefs, pool.peak_in_use, list(pool.grant_log),
            pool.aborted_batches, pool.lock_stats()["acquires"])


def _both(pools, fn):
    """Apply ``fn`` to the JAX pool and the port's; the results (or the
    exception types) and the pools' whole state must agree."""
    out = []
    for pool in pools:
        try:
            r = fn(pool)
        except Exception as e:          # noqa: BLE001 - compared below
            r = ("raised", type(e).__name__)
        out.append(_norm(r))
    assert out[0] == out[1]
    assert _state(pools[0]) == _state(pools[1])
    return out[1]


def _norm(r):
    if isinstance(r, np.ndarray):
        return r.tolist()
    if isinstance(r, (list, tuple)):
        return type(r)(_norm(x) for x in r)
    return r


# ------------------------------------------------------------- refcounts
def test_shared_page_freed_exactly_once():
    pools = _pools(8, 4)
    ids = _both(pools, lambda p: p.alloc(2, tag="donor"))
    _both(pools, lambda p: p.incref_batch([ids]))
    assert _both(pools, lambda p: p.refcounts(ids)) == [2, 2]
    assert _both(pools, lambda p: p.free(ids)) == []
    assert pools[1].in_use == 2
    assert sorted(_both(pools, lambda p: p.free(ids))) == sorted(ids)
    for p in pools:
        p.check()
    assert pools[1].pages_alloced == pools[1].pages_freed == 2
    assert pools[1].increfs == 2 and pools[1].decrefs == 4
    _both(pools, lambda p: p.reset_stats())     # counters only, not pages
    assert pools[1].decrefs == 0 and pools[1].n_free == 8


def test_same_page_in_two_groups_of_one_batch():
    pools = _pools(8, 4)
    ids = _both(pools, lambda p: p.alloc(1, tag="a"))
    _both(pools, lambda p: p.incref_batch([ids]))
    assert _both(pools, lambda p: p.free_batch([ids, ids])) == ids
    assert pools[1].in_use == 0 and pools[1].frees == 2
    pools[1].check()


def test_refcount_violations_raise_atomically():
    pools = _pools(8, 4)
    ids = np.asarray(_both(pools, lambda p: p.alloc(2, tag="r")), np.int32)
    with pytest.raises(tkv.PageLeakError, match="twice in one free batch"):
        pools[1].free_batch([ids[:1], ids[:1]])
    with pytest.raises(jkv.PageLeakError):
        pools[0].free_batch([ids[:1], ids[:1]])
    for bad in ([[7]], [[99]]):
        assert _both(pools, lambda p: p.incref_batch(bad)) == (
            "raised", "PageLeakError")
    assert _both(pools, lambda p: p.refcounts(ids)) == [1, 1]
    _both(pools, lambda p: p.free(ids))
    assert _both(pools, lambda p: p.free(ids[:1])) == ("raised",
                                                       "PageLeakError")
    # a rolled-back batch counts as aborted in both pools alike
    assert _state(pools[0]) == _state(pools[1])
    pools[1].check()


def test_epochs_invalidate_recycled_pages():
    pools = _pools(4, 4)
    ids = _both(pools, lambda p: p.alloc(2, tag="a"))
    ep = _both(pools, lambda p: p.epochs(ids))
    assert _both(pools, lambda p: p.entry_valid(ids, ep)) is True
    _both(pools, lambda p: p.free(ids))
    assert _both(pools, lambda p: p.entry_valid(ids, ep)) is False
    _both(pools, lambda p: p.alloc(2, tag="b"))
    ids2 = _both(pools, lambda p: p.alloc(2, tag="c"))
    assert ids2 == ids                           # the recycled ids
    assert _both(pools, lambda p: p.entry_valid(ids2, ep)) is False
    assert _both(pools, lambda p: p.entry_valid([99], [0])) is False


def test_alloc_batch_incref_and_paired_decref_one_acquire():
    pools = _pools(8, 4)
    donor = np.asarray(_both(pools, lambda p: p.alloc(3, tag="donor")))
    _both(pools, lambda p: p.alloc_batch([2], ["adopter"],
                                         incref_groups=[donor[:2]]))
    got = _both(pools, lambda p: p.alloc_batch(
        [1, 1], [("cow", 0), ("cow", 1)], partial=True,
        paired_decrefs=[[donor[0]], [donor[1]]]))
    assert all(g is not None for g in got)
    assert _both(pools, lambda p: p.refcounts(donor)) == [1, 1, 1]
    _both(pools, lambda p: p.incref_batch([donor[:1]]))
    out = _both(pools, lambda p: p.alloc_batch(
        [p.n_free + 1], [("cow", 2)], partial=True,
        paired_decrefs=[[donor[0]]]))
    assert out == [None]                         # starved: no decref
    assert _both(pools, lambda p: p.refcounts(donor[:1])) == [2]
    # a paired decref beyond the held references refuses the whole call
    assert _both(pools, lambda p: p.alloc_batch(
        [1, 1], ["x", "y"], partial=True,
        paired_decrefs=[[donor[2]], [donor[2]]])) == ("raised",
                                                      "PageLeakError")
    for p in pools:
        p.check()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refcount_churn_no_leaks(seed):
    """Seeded alloc / incref / decref churn through both pools: every
    result and the whole state agree after every operation, and a full
    drain returns every page."""
    rng = np.random.default_rng(seed)
    pools = _pools(32, 4)
    refs = []
    for step in range(600):
        r = rng.random()
        if refs and (r < 0.35 or pools[1].n_free == 0):
            g = refs.pop(int(rng.integers(len(refs))))
            _both(pools, lambda p: p.free(g))
        elif refs and r < 0.55:
            g = refs[int(rng.integers(len(refs)))]
            _both(pools, lambda p: p.incref_batch([g]))
            refs.append(list(g))
        else:
            n = int(rng.integers(1, 4))
            if n <= pools[1].n_free:
                refs.append(_both(pools, lambda p: p.alloc(n, tag=step)))
    for g in refs:
        _both(pools, lambda p: p.free(g))
    for p in pools:
        p.check()
        assert p.in_use == 0
        assert p.decrefs == p.pages_alloced + p.increfs


@pytest.mark.parametrize("seed", [0, 1])
def test_threaded_incref_decref_batches(seed):
    """Threads hammer incref_batch / free_batch on shared groups of each
    pool under its ticket mutex; both end with the base references at 1
    and drain to the same empty state."""
    rng = np.random.default_rng(seed)
    n_threads = int(rng.integers(2, 5))
    ends = []
    for pool in _pools(48, 4):
        base = pool.alloc_batch([3] * 4, list("abcd"))
        errs = []

        def worker(tid, pool=pool, base=base, errs=errs):
            r = np.random.default_rng(seed + tid)
            held = []
            try:
                for _ in range(80):
                    if held and r.random() < 0.5:
                        pool.free_batch([held.pop(int(r.integers(len(held))))])
                    else:
                        g = base[int(r.integers(len(base)))]
                        pool.incref_batch([g])
                        held.append(np.array(g))
                if held:
                    pool.free_batch(held)
            except Exception as e:      # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads), "a worker hung"
        assert not errs, errs
        rc = pool.refcounts(np.concatenate(base)).tolist()
        pool.check()
        pool.free_batch(base)
        pool.check()
        ends.append((rc, pool.in_use, pool.pages_alloced, pool.pages_freed,
                     pool.increfs, pool.decrefs))
    assert ends[0] == ends[1]
    assert ends[1][0] == [1] * 12 and ends[1][1] == 0


# ----------------------------------------------------------- prefix index
def _indexes(n, ps):
    pools = _pools(n, ps)
    return pools, (jkv.PrefixIndex(ps, pools[0]),
                   tkv.PrefixIndex(ps, pools[1]))


def _idx_both(idxs, fn):
    out = [_norm(fn(i)) for i in idxs]
    assert out[0] == out[1]
    assert [{k: (v[0].tolist(), v[1].tolist()) for k, v in i._entries.items()}
            for i in idxs[:1]] == [
        {k: (v[0].tolist(), v[1].tolist()) for k, v in idxs[1]._entries.items()}]
    assert (idxs[0].hits, idxs[0].misses, idxs[0].pruned) == \
        (idxs[1].hits, idxs[1].misses, idxs[1].pruned)
    return out[1]


def test_prefix_index_longest_match_and_partial_exact_length():
    pools, idxs = _indexes(16, 4)
    prompt = np.arange(10, dtype=np.int32)
    pages = np.asarray(_both(pools, lambda p: p.alloc(3, tag="donor")))
    assert _idx_both(idxs, lambda i: i.register(prompt, 16, pages)) == 3
    for sched in (0, 4):
        _idx_both(idxs, lambda i: i.register(prompt, 0, pages,
                                             schedule=sched))
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 16)) == \
        (10, pages.tolist())
    longer = np.concatenate([prompt[:8], [90, 91, 92, 93]]).astype(np.int32)
    assert _idx_both(idxs, lambda i: i.lookup(longer, 16)) == \
        (8, pages[:2].tolist())
    other = np.concatenate([[99], prompt[1:]]).astype(np.int32)
    assert _idx_both(idxs, lambda i: i.lookup(other, 16)) == (0, None)
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 32)) == (0, None)
    # one-shot and chunked keys never cross: schedule 4 vs schedule 8
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 0, schedule=4))[0] \
        == 10
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 0, schedule=8)) == \
        (0, None)


def test_prefix_index_prunes_stale_entries():
    pools, idxs = _indexes(8, 4)
    prompt = np.arange(8, dtype=np.int32)
    pages = _both(pools, lambda p: p.alloc(2, tag="donor"))
    _idx_both(idxs, lambda i: i.register(prompt, 8, pages))
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 8))[0] == 8
    _both(pools, lambda p: p.free(pages))
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 8)) == (0, None)
    assert idxs[1].pruned >= 1
    again = _both(pools, lambda p: p.alloc(2, tag="other"))
    _idx_both(idxs, lambda i: i.register(prompt, 8, again))
    assert _idx_both(idxs, lambda i: i.lookup(prompt, 8))[0] == 8


# -------------------------------------------------- pool-level CoW split
class _JTiny:
    def init_cache(self, b, max_len, for_shapes=False):
        mk = (jax.ShapeDtypeStruct if for_shapes
              else lambda s, d: jnp.zeros(s, d))
        return {"periods": {"layer_0": {
                    "k": mk((2, b, max_len, 1, 2), jnp.float32),
                    "v": mk((2, b, max_len, 1, 2), jnp.float32)}},
                "leftover": {},
                "len": mk((), jnp.int32)}


class _TTiny:
    def init_cache(self, b, max_len, device, state_batch=None):
        # attention only: no state leaf takes ``state_batch``
        def mk():
            return torch.zeros((2, b, max_len, 1, 2), device=device)
        return {"periods": {"layer_0": {"k": mk(), "v": mk()}},
                "leftover": {},
                "len": torch.zeros((), dtype=torch.int32, device=device)}


def test_prepare_batch_splits_shared_write_target():
    """A donor inserts 8 tokens, an adopter shares both pages, and a
    write inside shared page 1 splits in one acquire: tables, refcounts,
    grant logs and the whole arena equal the reference's."""
    rng = np.random.default_rng(0)
    kv = {n: rng.standard_normal((2, 1, 8, 1, 2)).astype(np.float32)
          for n in ("k", "v")}
    jcache = {"periods": {"layer_0": {n: jnp.asarray(a)
                                      for n, a in kv.items()}},
              "leftover": {}, "len": jnp.zeros((), jnp.int32)}
    tcache = {"periods": {"layer_0": {n: torch.from_numpy(a)
                                      for n, a in kv.items()}},
              "leftover": {}}
    jpool = jkv.PagedSlotPool(_JTiny(), capacity=2, max_len=16, page_size=4)
    tpool = tkv.PagedSlotPool(_TTiny(), capacity=2, max_len=16, page_size=4,
                              device="cpu")
    outs = []
    for pool, cache in ((jpool, jcache), (tpool, tcache)):
        s0 = pool.acquire(0)
        pool.insert(s0, cache, 8, reserve=8)
        donor = pool.page_ids(s0)
        s1 = pool.acquire(1)
        pool.reserve_batch([(s1, 8)], shared=[donor])
        pool.insert(s1, cache, 8, reserve=8, ids=np.zeros(0, np.int32),
                    shared_ids=donor, shared_len=8)
        pool.check()
        hits = pool.shared_write_targets(s1, 6, 8)
        a0 = pool.pages.lock_stats()["acquires"]
        grow_ok, split_ok = pool.prepare_batch([], hits)
        outs.append((hits, grow_ok, split_ok,
                     pool.pages.lock_stats()["acquires"] - a0,
                     pool.pages.refcounts(donor).tolist(),
                     pool._tables.tolist(), list(pool.pages.grant_log),
                     {n: np.asarray(pool.arena["periods"]["layer_0"][n])
                      .tolist() for n in ("k", "v")}))
        pool.check()
        pool.evict(s0)
        pool.evict(s1)
        assert pool.pages.in_use == 0
    assert outs[0] == outs[1]
    hits, _, split_ok, acquires, rc, tables, _, arena = outs[1]
    assert [j for j, _ in hits] == [1] and split_ok == [True]
    assert acquires == 1 and rc == [2, 1]
    new_page, old_page = tables[1][1], tables[0][1]
    assert new_page != old_page
    k = np.asarray(arena["k"])
    np.testing.assert_array_equal(k[:, new_page], k[:, old_page])


@pytest.mark.parametrize("axis", [0, 1])
def test_copy_pages_matches_reference(axis):
    """``copy_pages`` against the reference's at tolerance 0, on a
    period-stacked arena (page axis 1) and a plain one (axis 0); a
    sentinel target drops, as the reference's scatter drops it."""
    rng = np.random.default_rng(axis)
    shape = ((6, 4, 3, 2) if axis == 0 else (3, 6, 4, 3, 2))
    arena = rng.standard_normal(shape).astype(np.float32)
    src = np.array([0, 4, 2, 5], np.int32)
    dst = np.array([1, 3, 6, 0], np.int32)          # 6 is the sentinel
    want = np.asarray(jattn.copy_pages(jnp.asarray(arena), jnp.asarray(src),
                                       jnp.asarray(dst), axis=axis))
    got = tattn.copy_pages(torch.from_numpy(arena.copy()), src, dst,
                           axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(AssertionError, match="duplicate"):
        tattn.copy_pages(torch.from_numpy(arena.copy()), [0, 1], [3, 3],
                         axis=axis)


# --------------------------------------------- engine stream equivalence
def _run_trace(cls, model, params, sharing, trace, extra, *, capacity,
               max_len, page_size=4, growth="lazy", chunk=2,
               prefill_chunk=None):
    eng = cls(model, params, capacity=capacity, max_len=max_len,
              decode_chunk=chunk, kv_layout="paged", page_size=page_size,
              page_growth=growth, prefix_sharing=sharing,
              prefill_chunk_tokens=prefill_chunk, eos_id=trace.get("eos"),
              **extra)
    pending = list(trace["arrivals"])            # (step, prompt, max_new)
    while pending or eng.queue or eng.active:
        while pending and pending[0][0] <= eng.step_clock:
            _, prompt, max_new = pending.pop(0)
            eng.submit(prompt, max_new)
        if eng.step() == 0 and not eng.queue and pending:
            eng.step_clock += 1                  # idle until next arrival
    eng.pool.check()
    assert eng.pool.pages.in_use == 0
    st = eng.stats()
    return {"grant_log": list(eng.grant_log),
            "streams": {r.rid: list(r.out_tokens) for r in eng.finished},
            "acquires": eng.pool.pages.lock_stats()["acquires"],
            **{k: st[k] for k in (
                "prefix_sharing", "prefix_hits", "shared_pages_adopted",
                "cow_splits", "pages_alloced", "page_increfs",
                "page_decrefs", "page_pauses", "page_preemptions",
                "prefill_tokens", "prefill_tokens_saved")}}


def _compare(models, trace, **kw):
    """Sharing on and off through both engines: each equals the
    reference's, and the port's streams with sharing on equal its own
    with sharing off."""
    jm, jp, tm, tp = models
    got = {}
    for sharing in ("on", "off"):
        want = _run_trace(JEngine, jm, jp, sharing, trace, {"seed": 0}, **kw)
        got[sharing] = _run_trace(SlotServeEngine, tm, tp, sharing, trace,
                                  {"device": "cpu"}, **kw)
        assert got[sharing] == want, sharing
    for k in ("grant_log", "streams"):
        assert got["on"][k] == got["off"][k]
    return got["on"], got["off"]


@pytest.mark.parametrize("prefill_chunk", [None, 4],
                         ids=["one-shot", "chunked"])
def test_sharing_on_off_identical_streams_same_prompt(models, prefill_chunk):
    cfg = models[0].cfg
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, cfg.vocab_size, 10)
    gap = 2 if prefill_chunk is None else 6      # chunked: donor done first
    arrivals = [(0, prompt, 6), (gap, prompt.copy(), 6),
                (gap + 2, prompt.copy(), 4)]
    on, off = _compare(models, {"arrivals": arrivals}, capacity=3,
                       max_len=24, prefill_chunk=prefill_chunk)
    assert on["prefix_hits"] == 2
    assert on["pages_alloced"] < off["pages_alloced"]
    if prefill_chunk is None:
        assert on["shared_pages_adopted"] >= 4 and on["cow_splits"] >= 1
    else:
        # adoption skips whole chunks: lcm(4, 4) aligned, last one private
        assert on["prefill_tokens_saved"] == 16


def test_sharing_boundary_prefix_different_suffixes(models):
    cfg = models[0].cfg
    rng = np.random.default_rng(5)
    head = rng.integers(1, cfg.vocab_size, 8)

    def mk():
        return np.concatenate(
            [head, rng.integers(1, cfg.vocab_size, 4)]).astype(np.int32)
    arrivals = [(0, mk(), 5), (2, mk(), 5), (4, mk(), 3)]
    on, _ = _compare(models, {"arrivals": arrivals}, capacity=3, max_len=24)
    assert on["prefix_hits"] == 2 and on["shared_pages_adopted"] == 4


def test_sharing_mixed_prompt_lengths_same_bucket(models):
    cfg = models[0].cfg
    rng = np.random.default_rng(21)
    head = rng.integers(1, cfg.vocab_size, 8)
    donor = np.concatenate(
        [head, rng.integers(1, cfg.vocab_size, 8)]).astype(np.int32)
    shorter = np.concatenate(
        [head, rng.integers(1, cfg.vocab_size, 4)]).astype(np.int32)
    arrivals = [(0, donor, 6), (4, shorter, 6)]
    on, _ = _compare(models, {"arrivals": arrivals}, capacity=2, max_len=32)
    assert on["prefix_hits"] == 1 and on["shared_pages_adopted"] == 2


@pytest.mark.parametrize("prefill_chunk", [None, 8],
                         ids=["one-shot", "chunked"])
def test_donor_side_split_while_decoding_partial_page(models,
                                                      prefill_chunk):
    """The keeper rule: the donor, still writing inside its partial
    prompt page when the adopter joins, keeps the page; the adopter
    splits."""
    cfg = models[0].cfg
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, cfg.vocab_size, 9 if prefill_chunk is None
                          else 17)
    arrivals = [(0, prompt, 10), (2 if prefill_chunk is None else 6,
                                  prompt.copy(), 10)]
    on, _ = _compare(models, {"arrivals": arrivals}, capacity=2,
                     max_len=40, page_size=8, prefill_chunk=prefill_chunk)
    assert on["prefix_hits"] == 1
    if prefill_chunk is None:
        assert on["cow_splits"] >= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharing_equivalence_random_divergence_points(models, seed):
    """Seeded prompt lengths, repeat / extend / diverge mixes, growth
    mode and decode chunk: both engines agree with sharing on and off,
    and drain leak-free."""
    cfg = models[0].cfg
    rng = np.random.default_rng(seed)
    base_len = int(rng.integers(4, 12))
    base = rng.integers(1, cfg.vocab_size, base_len)
    arrivals = []
    step = 0
    for _ in range(int(rng.integers(3, 6))):
        step += int(rng.integers(1, 4))
        kind = rng.random()
        if kind < 0.5:
            p = base.copy()
        elif kind < 0.8 and base_len > 4:
            cut = int(rng.integers(2, base_len))
            p = np.concatenate(
                [base[:cut], rng.integers(1, cfg.vocab_size, base_len - cut)])
        else:
            p = rng.integers(1, cfg.vocab_size, base_len)
        arrivals.append((step, p.astype(np.int32), int(rng.integers(2, 6))))
    growth = "lazy" if rng.random() < 0.7 else "eager"
    _compare(models, {"arrivals": arrivals, "eos": 0}, capacity=2,
             max_len=24, growth=growth, chunk=int(rng.integers(1, 3)))


def test_prefix_hit_does_not_jump_admission_fifo(models):
    """A follower with a 100 % prefix hit still waits behind a
    page-starved FIFO head, in both engines alike."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jm.cfg.vocab_size, 8)
    stranger = rng.integers(1, jm.cfg.vocab_size, 8)
    outs = []
    for cls, m, p, extra in ((JEngine, jm, jp, {"seed": 0}),
                             (SlotServeEngine, tm, tp, {"device": "cpu"})):
        eng = cls(m, p, capacity=3, max_len=16, kv_layout="paged",
                  page_size=4, decode_chunk=2, prefix_sharing="on",
                  num_pages=12, **extra)
        donor = eng.submit(prompt, 16)
        eng.step()
        eng.submit(stranger, 16)
        eng.submit(prompt.copy(), 2)
        eng.run_until_done(max_rounds=200)
        eng.pool.check()
        assert eng.pool.pages.in_use == 0 and len(eng.finished) == 3
        outs.append((list(eng.grant_log),
                     {r.rid: list(r.out_tokens) for r in eng.finished},
                     eng.pool.pages.lock_stats()["acquires"],
                     eng.stats()["prefix_hits"]))
        assert eng.grant_log == [donor.rid, donor.rid + 1, donor.rid + 2]
    assert outs[0] == outs[1]


def test_sharing_matches_contiguous_layout(models):
    """The paged engine with sharing on reproduces the port's contiguous
    slot arena, and both equal the reference's paged engine."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, jm.cfg.vocab_size, 8)
    arrivals = [(0, prompt, 4), (2, prompt.copy(), 4),
                (3, rng.integers(1, jm.cfg.vocab_size, 6), 3)]
    want = _run_trace(JEngine, jm, jp, "on", {"arrivals": arrivals},
                      {"seed": 0}, capacity=2, max_len=24)
    paged = _run_trace(SlotServeEngine, tm, tp, "on", {"arrivals": arrivals},
                       {"device": "cpu"}, capacity=2, max_len=24)
    assert paged == want and paged["prefix_hits"] >= 1
    slots = SlotServeEngine(tm, tp, capacity=2, max_len=24, decode_chunk=2,
                            device="cpu")
    pending = list(arrivals)
    while pending or slots.queue or slots.active:
        while pending and pending[0][0] <= slots.step_clock:
            _, p, m = pending.pop(0)
            slots.submit(p, m)
        if slots.step() == 0 and not slots.queue and pending:
            slots.step_clock += 1
    assert (list(slots.grant_log),
            {r.rid: list(r.out_tokens) for r in slots.finished}) == \
        (paged["grant_log"], paged["streams"])
