"""The reference's default serving path, held to the JAX package on the
reduced qwen3-14b (float32, the reference's weights through the bridge,
requests from a numpy seed):

* ``batch_axes`` and the contiguous ``SlotPool`` — its FIFO free list,
  ``acquire`` / ``evict`` / ``insert`` / ``assign``, arena rows and
  lengths — against the JAX ``SlotPool``;
* the legacy ``ServeEngine.generate`` tokens, with and without eos;
* ``ContinuousBatcher``: the batches each tick, the finish order and the
  tick count;
* ``SlotServeEngine`` streams, ``grant_log`` and (paged) allocator lock
  acquires on the slots layout one-shot at decode chunk 1 and 2, slots
  chunked, paged one-shot with eager and lazy growth, capacity below the
  request count, and with an ``eos_id`` that fires: all exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve import kv_slots as jslots
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import SlotServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import kv_slots as tslots
from repro_torch.serve.engine import ServeEngine, SlotServeEngine
from repro_torch.serve.scheduler import ContinuousBatcher, Request

TOL = 1e-4


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


# -------------------------------------------------------------- SlotPool
def test_batch_axes_match_reference(models):
    jm, _, tm, _ = models
    assert tslots.batch_axes(tm) == jslots.batch_axes(jm, 16)
    leaves = tslots.cache_leaves(tm.init_cache(3, 16, "cpu"))
    want = jax.tree_util.tree_leaves(
        {k: v for k, v in jm.init_cache(3, 16).items() if k != "len"})
    assert [tuple(x[3].shape) for x in leaves] == [w.shape for w in want]


def test_slot_pool_matches_reference(models):
    """Acquire three slots, insert two prefilled requests, evict and
    re-acquire (FIFO reuse order), insert again, assign one for chunked
    prefill: free lists, lengths and every arena row equal."""
    jm, jp, tm, tp = models
    jpool = jslots.SlotPool(jm, 3, 12)
    tpool = tslots.SlotPool(tm, 3, 12, "cpu")
    assert tpool.virtual_max_len == jpool.virtual_max_len == 12

    def insert(rid, n):
        tok = np.random.default_rng(rid).integers(0, 512, (1, n)).astype(
            np.int32)
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=12)
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                           max_len=12)
        slots = (jpool.acquire(rid), tpool.acquire(rid))
        assert slots[0] == slots[1]
        jpool.insert(slots[0], jc, n)
        tpool.insert(slots[1], tc, n)
        return slots[0]

    a = insert(10, 5)
    insert(11, 9)
    c = (jpool.acquire(12), tpool.acquire(12))[0]
    jpool.evict(a)
    tpool.evict(a)
    assert jpool._free == tpool._free and tpool.n_free == 1
    assert insert(13, 3) == a                # the freed slot comes back
    jpool.assign(c, 4)
    tpool.assign(c, 4)
    assert tpool._rid == jpool._rid == [13, 11, 12]
    assert tpool.lens.tolist() == np.asarray(jpool.lens).tolist()
    jv, tv = jpool.cache_view(), tpool.cache_view()
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tv["periods"]["layer_0"][name].numpy(),
            np.asarray(jv["periods"]["layer_0"][name]), atol=TOL, rtol=0)
    with pytest.raises(RuntimeError, match="exhausted"):
        tpool.acquire(14)
    tpool.evict(c)
    with pytest.raises(RuntimeError, match="evicting free slot"):
        tpool.evict(c)


# ---------------------------------------------------------------- legacy
@pytest.mark.parametrize("eos", [False, True])
def test_legacy_engine_tokens_match_reference(models, eos):
    """Two prompts prefilled in one batch, 6 greedy tokens each; with eos
    (a token the run without it emits mid-stream) a finished row keeps
    emitting eos and the loop stops once every row has."""
    jm, jp, tm, tp = models
    tok = np.random.default_rng(8).integers(0, 512, (2, 7)).astype(np.int32)
    eos_id = None
    if eos:
        free = ServeEngine(tm, tp, max_len=16).generate(
            {"tokens": torch.from_numpy(tok)}, 6).tokens
        eos_id = int(free[0, 2])
    want = JServeEngine(jm, jp, max_len=16).generate(
        {"tokens": jnp.asarray(tok)}, 6, eos_id=eos_id).tokens
    got = ServeEngine(tm, tp, max_len=16).generate(
        {"tokens": torch.from_numpy(tok)}, 6, eos_id=eos_id).tokens
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.asarray(want).tolist()
    if eos:
        assert int(got[0, -1]) == eos_id


def test_legacy_engine_refuses_sampling(models):
    """Sampling raised "not ported yet" before the recurrent slice; now
    the legacy engine samples (held in tests/test_torch_sampling.py):
    its default stream is the generator seeded 0, drawn on the batch's
    device, and differs from another seed's."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, temperature=0.5)
    batch = {"tokens": torch.arange(1, 7, dtype=torch.int32)[None]}
    got = eng.generate(batch, 5).tokens
    assert got.tolist() == eng.generate(
        batch, 5, generator=torch.Generator().manual_seed(0)).tokens.tolist()
    assert got.shape == (1, 5)
    assert got.tolist() != eng.generate(
        batch, 5, generator=torch.Generator().manual_seed(1)).tokens.tolist()


# ----------------------------------------------------- ContinuousBatcher
@pytest.mark.parametrize("capacity,finish_every", [(2, 0), (3, 4), (1, 2)])
def test_continuous_batcher_matches_reference(capacity, finish_every):
    """Seven requests of 1-4 tokens; ``decode_fn`` also finishes every
    ``finish_every``-th request early: the same batch each tick, the
    same finish order, the same tick count."""
    rng = np.random.default_rng(capacity * 10 + finish_every)
    news = rng.integers(1, 5, 7).tolist()

    def run(batcher_cls, request_cls):
        seen = []

        def decode(rids):
            seen.append(list(rids))
            return [bool(finish_every) and r % finish_every == 0 and
                    len(seen) % 2 == 0 for r in rids]

        b = batcher_cls(capacity=capacity, decode_fn=decode)
        reqs = [request_cls(rid=i, prompt_len=4, max_new_tokens=n)
                for i, n in enumerate(news)]
        for r in reqs:
            b.submit(r)
        ticks = b.drain()
        assert all(r.done.is_set() for r in reqs)
        return seen, [r.rid for r in b.finished], ticks

    want = run(JBatcher, JRequest)
    got = run(ContinuousBatcher, Request)
    assert got == want
    assert all(len(batch) <= capacity for batch in got[0])


# ---------------------------------------------------------------- engine
def _serve(engine_cls, model, params, reqs, **kw):
    extra = {"device": "cpu"} if engine_cls is SlotServeEngine else {}
    eng = engine_cls(model, params, max_len=32, **kw, **extra)
    handles = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    st = eng.stats()
    if kw.get("kv_layout") == "paged":
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
    return {"streams": {r.rid: list(r.out_tokens) for r in handles},
            "grant_log": list(eng.grant_log),
            "acquires": st.get("lock_acquires"),
            "dispatches": st["decode_dispatches"],
            "prefill_tokens": st["prefill_tokens"],
            "pad_tokens": st["pad_tokens"]}


CONFIGS = {
    "slots-oneshot-dc1": dict(kv_layout="slots", decode_chunk=1),
    "slots-oneshot-dc2": dict(kv_layout="slots", decode_chunk=2),
    "slots-chunked": dict(kv_layout="slots", decode_chunk=2,
                          prefill_chunk_tokens=4),
    "paged-oneshot-eager": dict(kv_layout="paged", page_size=4,
                                decode_chunk=2, page_growth="eager",
                                prefix_sharing="off"),
    "paged-oneshot-lazy-fused": dict(kv_layout="paged", page_size=4,
                                     decode_chunk=2, prefix_sharing="off",
                                     attention_impl="fused"),
    "slots-capacity-below-requests": dict(kv_layout="slots", decode_chunk=2,
                                          capacity=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference(models, name):
    jm, jp, tm, tp = models
    kw = dict(capacity=3)
    kw.update(CONFIGS[name])
    reqs = _requests(1)
    want = _serve(JEngine, jm, jp, reqs, **kw)
    got = _serve(SlotServeEngine, tm, tp, reqs, **kw)
    assert got == want
    assert got["grant_log"] == sorted(got["grant_log"])


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_with_eos_matches_reference(models, chunked):
    """An ``eos_id`` taken from the middle of a stream of the run without
    it, so it fires: the eos row retires early, both engines alike."""
    jm, jp, tm, tp = models
    kw = dict(kv_layout="slots", decode_chunk=2, capacity=2)
    if chunked:
        kw["prefill_chunk_tokens"] = 4
    reqs = _requests(4)
    free = _serve(SlotServeEngine, tm, tp, reqs, **kw)
    stream = max(free["streams"].values(), key=len)
    kw["eos_id"] = int(stream[1])
    want = _serve(JEngine, jm, jp, reqs, **kw)
    got = _serve(SlotServeEngine, tm, tp, reqs, **kw)
    assert got == want
    assert got["streams"] != free["streams"]


def test_prefix_sharing_auto_resolves_off_on_slots(models):
    """As in the reference: "auto" means off on the contiguous arena,
    "on" there is an error, and the fused kernel needs the paged one."""
    _, _, tm, tp = models
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=16,
                          prefix_sharing="auto", prefix_cache="auto",
                          device="cpu")
    eng.submit(np.arange(5), 3)
    eng.run_until_done()
    assert len(eng.finished[0].out_tokens) == 3
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        SlotServeEngine(tm, tp, capacity=2, max_len=16, prefix_sharing="on",
                        device="cpu")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        SlotServeEngine(tm, tp, capacity=2, max_len=16,
                        attention_impl="fused", device="cpu")
