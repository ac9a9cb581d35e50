"""The port's ``SlotServeEngine`` on the CPU against the JAX
``SlotServeEngine`` on the same seeded requests and bridged weights:
paged layout, chunked prefill (chunk 4), page size 4, decode chunk 2,
capacity 3, fused attention, bucketed dispatch on and off, prefix
sharing off. Greedy token streams, the FIFO ``grant_log``, the
allocator's lock acquires, pauses and preemptions must be identical,
and both pools must drain to zero pages in use — including arenas small
enough to pause and preempt. Also: sampling, fault injection,
cancellation and deadlines, outside earlier slices, serve (sampling
resolving the reference's gates; its streams are held in
tests/test_torch_sampling.py) and match; the former gaps (the slot arena, one-shot
prefill, eager growth, prefix sharing and the prefix cache) serve and
match the reference, the prefix defaults resolve as the reference's,
and the entry point refuses to run without a card unless asked for the
CPU. The slot layout and one-shot prefill are held to the JAX engine in
tests/test_torch_slots.py; sharing and the cache in
tests/test_torch_prefix_sharing.py and tests/test_torch_prefix_cache.py."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import SlotServeEngine


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _requests(seed, n=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(rng.integers(3, 15))).astype(
        np.int32), int(rng.integers(2, 7))) for _ in range(n)]


def _run(engine_cls, model, params, reqs, **kw):
    kw.setdefault("capacity", 3)
    eng = engine_cls(model, params, max_len=32, kv_layout="paged",
                     page_size=4, prefill_chunk_tokens=4, decode_chunk=2,
                     prefix_sharing="off", **kw)
    handles = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    eng.pool.check()
    assert eng.pool.pages.in_use == 0
    st = eng.stats()
    return {"streams": {r.rid: list(r.out_tokens) for r in handles},
            "grant_log": list(eng.grant_log),
            "acquires": eng.pool.pages.lock_stats()["acquires"],
            "pauses": st["page_pauses"],
            "preemptions": st["page_preemptions"],
            "dispatches": st["decode_dispatches"],
            "prefill_chunks": st["prefill_chunks"]}


def _compare(models, reqs, **kw):
    jm, jp, tm, tp = models
    want = _run(JEngine, jm, jp, reqs, seed=0, **kw)
    got = _run(SlotServeEngine, tm, tp, reqs, device="cpu", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("bucketed", ["on", "off"])
@pytest.mark.parametrize("num_pages", [None, 10, 6])
def test_streams_grants_and_locks_match_reference(models, bucketed,
                                                  num_pages):
    got = _compare(models, _requests(0), attention_impl="fused",
                   bucketed_dispatch=bucketed, num_pages=num_pages)
    if num_pages == 10:
        assert got["pauses"] > 0          # the arena is tight enough
    if num_pages == 6:
        assert got["preemptions"] > 0


def test_gather_impl_matches_reference(models):
    _compare(models, _requests(1), attention_impl="gather",
             bucketed_dispatch="on")


def test_bucket_pad_lanes_match_reference(models):
    """Capacity 5: three or four active slots dispatch in a bucket of 4
    with pad lanes (row id K) whose results must never be scattered
    back."""
    _compare(models, _requests(2, n=9), attention_impl="fused",
             bucketed_dispatch="on", capacity=5)


def test_bucket_pad_lanes_leave_vacant_slots_untouched(models):
    _, _, tm, tp = models
    eng = SlotServeEngine(tm, tp, capacity=4, max_len=32, kv_layout="paged",
                          page_size=4, prefill_chunk_tokens=4,
                          decode_chunk=2, attention_impl="fused",
                          bucketed_dispatch="on", device="cpu")
    for p, n in _requests(3, n=3):
        eng.submit(p, n)
    eng.step()
    assert ("round", 4, 2, 4) in eng._dispatch_cache.shapes
    vacant = (set(range(4)) - set(eng.active)).pop()
    assert int(eng.pool.lens[vacant]) == 0
    assert int(eng._last_tok[vacant]) == 0
    eng.run_until_done()
    assert eng.pool.pages.in_use == 0


@pytest.fixture(scope="module")
def moe_model():
    tm = build_model(get_arch("olmoe-1b-7b").reduced())
    return tm, tm.init(torch.Generator().manual_seed(0), "cpu")


def _serve_staggered(tm, tp, bucketed):
    """Capacity 8: two long decoders, then prompts of 3-14 tokens
    arriving over the next rounds, so rows prefill in different rounds
    beside rows that only decode. Returns what was served and, per
    round with a chunk, ``(chunk rows, decode bucket rows, rows of the
    model's chunk call)``."""
    rng = np.random.default_rng(11)
    eng = SlotServeEngine(tm, tp, capacity=8, max_len=48, kv_layout="paged",
                          page_size=4, prefill_chunk_tokens=4,
                          decode_chunk=2, attention_impl="fused",
                          prefix_sharing="off", bucketed_dispatch=bucketed,
                          device="cpu")
    rounds, calls = [], []
    dispatch, chunk = eng._dispatch, tm.prefill_chunk

    def counted_dispatch(view, frozen, chunk_rows, steps):
        if chunk_rows:
            rounds.append((len(chunk_rows),
                           eng._dispatch_cache.bucket(len(eng.active))
                           if eng.bucketed_dispatch else eng.capacity))
        return dispatch(view, frozen, chunk_rows, steps)

    def counted_chunk(params, cache, tokens, *rest):
        calls.append(int(tokens.shape[0]))
        return chunk(params, cache, tokens, *rest)

    eng._dispatch = counted_dispatch
    tm.prefill_chunk = counted_chunk
    try:
        hs = [eng.submit(rng.integers(0, 512, 5).astype(np.int32), 20)
              for _ in range(2)]
        for r in range(8):
            eng.step()
            for _ in range(r % 3):
                hs.append(eng.submit(rng.integers(
                    0, 512, int(rng.integers(3, 15))).astype(np.int32),
                    int(rng.integers(2, 7))))
        eng.run_until_done()
    finally:
        del tm.prefill_chunk
    eng.pool.check()
    assert eng.pool.pages.in_use == 0
    served = ({h.rid: list(h.out_tokens) for h in hs}, list(eng.grant_log),
              eng.pool.pages.lock_stats()["acquires"])
    return served, [(n, kb, c) for (n, kb), c in zip(rounds, calls)], eng


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_prefill_chunk_runs_over_its_own_rows(request, models, arch):
    """Bucketed, each round's prefill chunk runs over a gather of the
    rows that have a chunk, padded to their own bucket, not over the
    decode bucket; what is served equals the unbucketed engine's."""
    tm, tp = (models[2:] if arch == "dense"
              else request.getfixturevalue("moe_model"))
    off, off_rounds, _ = _serve_staggered(tm, tp, "off")
    on, on_rounds, eng = _serve_staggered(tm, tp, "on")
    assert on == off
    assert len({n for n, _, _ in on_rounds}) > 1
    assert all(c == eng._dispatch_cache.bucket(n) for n, _, c in on_rounds)
    assert any(c < kb for _, kb, c in on_rounds)
    assert all(c == 8 for _, _, c in off_rounds)
    assert len(on_rounds) == len(off_rounds)


@pytest.mark.parametrize("kw,what", [
    (dict(temperature=0.7), "sampling"),
    (dict(kv_layout="slots", temperature=0.7), "sampling"),
    (dict(prefix_sharing="on"), "prefix sharing"),
    (dict(prefix_sharing="auto"), "prefix sharing"),
    (dict(prefix_cache="on"), "prefix cache"),
    (dict(prefix_cache="auto"), "prefix cache"),
    (dict(fault_plan="seeded"), "fault injection"),
    (dict(kv_layout="slots", fault_plan="seeded"), "fault injection"),
])
def test_features_outside_the_slice_raise(models, kw, what):
    """Every case was outside an earlier slice and now builds and serves
    to the end: prefix sharing and the prefix cache ("on", and "auto" on
    the paged layout) and fault injection match the JAX engine; sampling
    resolves the JAX engine's gates and finishes every request."""
    if what == "sampling":
        _serve_sampling_case(models, kw)
        return
    if what.startswith("prefix"):
        _serve_prefix_case(models, kw)
        return
    if what == "fault injection":
        _serve_fault_case(models, kw)
        return
    raise AssertionError(f"unexpected case {what!r}")


def _serve_sampling_case(models, kw):
    """A sampled engine (T 0.7) resolves the JAX engine's gates — eager
    growth, no chunking, no bucketing, no sharing — and serves four
    requests to the end, pages drained."""
    jm, jp, tm, tp = models
    args = dict(capacity=2, max_len=32, kv_layout="paged",
                prefill_chunk_tokens=4, page_size=4, decode_chunk=2)
    args.update(kw)
    engs = [JEngine(jm, jp, seed=0, **args),
            SlotServeEngine(tm, tp, device="cpu", **args)]
    got = [(e.page_growth, e.prefill_chunk, e.bucketed_dispatch,
            e.prefix_sharing, e.prefix_cache is None) for e in engs]
    assert got[1] == got[0] == ("eager", 0, False, False, True)
    eng = engs[1]
    reqs = _requests(6, n=4)
    hs = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    assert [len(h.out_tokens) for h in hs] == [n for _, n in reqs]
    assert eng.grant_log == [0, 1, 2, 3]
    if eng.paged:
        eng.pool.check()
        assert eng.pool.pages.in_use == 0


def _serve_prefix_case(models, kw):
    """A prompt, the same prompt again once the first has prefilled
    (while it decodes), a drain, then the prompt once more: streams,
    ``grant_log``, acquires and the sharing and cache statistics equal
    the JAX engine's, and the pool drains."""
    jm, jp, tm, tp = models
    prompt = np.random.default_rng(5).integers(1, 512, 9).astype(np.int32)
    outs = []
    for cls, m, p, extra in ((JEngine, jm, jp, {"seed": 0}),
                             (SlotServeEngine, tm, tp, {"device": "cpu"})):
        eng = cls(m, p, capacity=2, max_len=16, kv_layout="paged",
                  prefill_chunk_tokens=4, page_size=4, decode_chunk=2,
                  **kw, **extra)
        hs = [eng.submit(prompt, 6)]
        for _ in range(3):                  # three 4-token chunks
            eng.step()
        hs.append(eng.submit(prompt, 3))
        eng.run_until_done()
        hs.append(eng.submit(prompt, 3))
        eng.run_until_done()
        assert [len(h.out_tokens) for h in hs] == [6, 3, 3]
        st = eng.stats()
        outs.append(({h.rid: list(h.out_tokens) for h in hs},
                     list(eng.grant_log),
                     eng.pool.pages.lock_stats()["acquires"],
                     {k: v for k, v in st.items() if k.startswith("cache_")
                      or k in ("prefix_sharing", "prefix_cache",
                               "prefix_hits", "shared_pages_adopted",
                               "cow_splits", "prefill_tokens_saved")}))
        eng.drop_prefix_cache()
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
    assert outs[1] == outs[0]
    assert outs[1][3]["prefix_hits"] > 0


def _serve_fault_case(models, kw):
    """Four requests under one seeded FaultPlan (allocator aborts and
    dispatch failures; the slot arena has no allocator, so only the
    latter fire there): streams, ``grant_log``, the faults by kind and
    the retry counts equal the JAX engine's, every request finishes."""
    from repro.serve.faults import FaultPlan as JFaultPlan
    from repro_torch.serve.faults import FaultPlan
    jm, jp, tm, tp = models
    kw = {k: v for k, v in kw.items() if k != "fault_plan"}
    reqs = _requests(3, n=4)
    outs = []
    for cls, m, p, extra, plan in ((JEngine, jm, jp, {"seed": 0},
                                    JFaultPlan),
                                   (SlotServeEngine, tm, tp,
                                    {"device": "cpu"}, FaultPlan)):
        fp = plan(31, alloc_rate=0.2, dispatch_rate=0.2)
        args = dict(capacity=2, max_len=32, kv_layout="paged",
                    prefill_chunk_tokens=4, page_size=4, decode_chunk=2,
                    fault_plan=fp, retry_backoff_s=0.0, **extra)
        args.update(kw)
        eng = cls(m, p, **args)
        hs = [eng.submit(q, n) for q, n in reqs]
        eng.run_until_done()
        st = eng.stats()
        outs.append(([list(h.out_tokens) for h in hs], list(eng.grant_log),
                     dict(fp.by_kind), st["rounds_retried"],
                     st["finished"]))
    assert outs[1] == outs[0]
    assert outs[1][2].get("dispatch", 0) > 0 and outs[1][4] == 4


@pytest.mark.parametrize("layout", ["paged", "slots"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["one-shot", "chunked"])
def test_prefix_defaults_resolve_as_reference(models, layout, chunk):
    """With no prefix arguments both engines resolve sharing and the
    cache alike: sharing on for the paged layout, the cache off, the
    watermark at the admission headroom."""
    jm, jp, tm, tp = models
    engs = [cls(m, p, capacity=2, max_len=16, kv_layout=layout,
                prefill_chunk_tokens=chunk, **extra)
            for cls, m, p, extra in ((JEngine, jm, jp, {}),
                                     (SlotServeEngine, tm, tp,
                                      {"device": "cpu"}))]
    got = [(e.prefix_sharing, e.prefix_index is None,
            e.prefix_cache is None, e.cache_watermark) for e in engs]
    assert got[1] == got[0]
    assert got[1][0] == (layout == "paged") and got[1][2]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="slots", prefill_chunk_tokens=4),
    dict(kv_layout="paged", prefill_chunk_tokens=None),
    dict(kv_layout="paged", prefill_chunk_tokens=4, page_growth="eager"),
], ids=["contiguous slot arena", "one-shot prefill", "page_growth eager"])
def test_former_gaps_build_and_serve(models, kw):
    """The cases that raised "not ported yet" before this slice now build
    an engine and serve a request to the end."""
    _, _, tm, tp = models
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=16, page_size=4,
                          device="cpu", **kw)
    req = eng.submit(np.arange(5, dtype=np.int32), 3)
    eng.run_until_done()
    assert eng.finished == [req] and len(req.out_tokens) == 3
    assert eng.grant_log == [0]


def test_deadlines_and_cancel_raise(models):
    """Deadlines and cancellation raised "not ported yet" in earlier
    slices; now they work (held to the JAX engine in
    tests/test_torch_lifecycle.py): a deadline already past expires the
    request in the queue, an unknown rid is refused, and a queued
    request is torn down at once."""
    _, _, tm, tp = models
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=16,
                          prefill_chunk_tokens=4, device="cpu")
    late = eng.submit(np.arange(3), 2, deadline_step=-1)
    assert not eng.cancel(12345)
    queued = eng.submit(np.arange(3), 2)
    assert eng.cancel(queued.rid) and queued.state.value == "cancelled"
    eng.run_until_done()
    assert late.state.value == "expired" and eng.grant_log == []
    assert eng.stats()["expired"] == 1 and eng.stats()["cancelled"] == 1


def test_engine_defaults_to_the_card(models):
    _, _, tm, tp = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotServeEngine(tm, tp, capacity=2, max_len=16,
                        prefill_chunk_tokens=4)
