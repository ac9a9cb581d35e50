"""The port's ``SlotServeEngine`` on the CPU against the JAX
``SlotServeEngine`` on the same seeded requests and bridged weights:
paged layout, chunked prefill (chunk 4), page size 4, decode chunk 2,
capacity 3, fused attention, bucketed dispatch on and off, prefix
sharing off. Greedy token streams, the FIFO ``grant_log``, the
allocator's lock acquires, pauses and preemptions must be identical,
and both pools must drain to zero pages in use — including arenas small
enough to pause and preempt. Also: every feature outside the slice
raises at construction, and the entry point refuses to run without a
card unless asked for the CPU."""

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
    eng = SlotServeEngine(tm, tp, capacity=4, max_len=32, page_size=4,
                          prefill_chunk_tokens=4, decode_chunk=2,
                          attention_impl="fused", bucketed_dispatch="on",
                          device="cpu")
    for p, n in _requests(3, n=3):
        eng.submit(p, n)
    eng.step()
    assert ("round", 4, 2, 4) in eng._dispatch_cache.shapes
    vacant = (set(range(4)) - set(eng.active)).pop()
    assert int(eng.pool.lens[vacant]) == 0
    assert int(eng._last_tok[vacant]) == 0
    eng.run_until_done()
    assert eng.pool.pages.in_use == 0


@pytest.mark.parametrize("kw,what", [
    (dict(kv_layout="slots"), "contiguous slot arena"),
    (dict(temperature=0.7), "sampling"),
    (dict(prefill_chunk_tokens=None), "one-shot prefill"),
    (dict(page_growth="eager"), "page_growth"),
    (dict(prefix_sharing="on"), "prefix sharing"),
    (dict(prefix_sharing="auto"), "prefix sharing"),
    (dict(prefix_cache="on"), "prefix cache"),
    (dict(fault_plan=object()), "fault injection"),
])
def test_features_outside_the_slice_raise(models, kw, what):
    _, _, tm, tp = models
    args = dict(capacity=2, max_len=16, prefill_chunk_tokens=4,
                device="cpu")
    args.update(kw)
    with pytest.raises(ValueError, match=f"{what}.*not ported yet"):
        SlotServeEngine(tm, tp, **args)


def test_deadlines_and_cancel_raise(models):
    _, _, tm, tp = models
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=16,
                          prefill_chunk_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="deadlines is not ported yet"):
        eng.submit(np.arange(3), 2, deadline_step=5)
    with pytest.raises(ValueError, match="cancellation is not ported yet"):
        eng.cancel(0)


def test_engine_defaults_to_the_card(models):
    _, _, tm, tp = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotServeEngine(tm, tp, capacity=2, max_len=16,
                        prefill_chunk_tokens=4)
