"""The port's ``SlotServeEngine`` serving the other attention-only
decoders, reduced, on the CPU, against the JAX ``SlotServeEngine`` on
the same seeded requests and bridged weights (the families of
tests/test_torch_families.py: olmoe-1b-7b, phi3.5-moe-42b-a6.6b,
gemma3-1b, gemma3-1b with two leftover layers, minitron-4b,
qwen1.5-110b).

Two engine configurations each: the main path (paged arena of page size
4, chunked prefill of 4, fused decode attention, bucketed dispatch,
prefix sharing ``auto`` as the reference resolves it, with one prompt
repeated so that it has something to adopt) and the reference
launcher's default path (the contiguous slot arena, one-shot prefill).
On gemma3 with leftover layers also the paged arena with one-shot
prefill where a repeated prompt splits a shared partial page (a CoW
split). Greedy streams, the FIFO ``grant_log`` and the allocator's
acquires must be identical, and both pools drain to no page in use.
gemma3's prompts (up to 20 tokens) pass its reduced window of 8.

An MoE layer's capacity is per row over the tokens of one call, so the
K/V of an MoE prompt depends on chunking, bucket padding and sharing:
these runs compare the two packages at equal settings and assert no
identity across settings."""

import numpy as np
import pytest

from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.serve.engine import SlotServeEngine
from test_torch_families import FAMILIES, models

MAIN = dict(kv_layout="paged", page_size=4, prefill_chunk_tokens=4,
            attention_impl="fused", bucketed_dispatch="on",
            prefix_sharing="auto")
SLOTS = dict(kv_layout="slots", prefill_chunk_tokens=None)


def _requests(seed, n=6):
    """n prompts of 3-20 tokens with 2-6 new tokens each; request 4
    repeats request 0's prompt."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, 512, size=int(rng.integers(3, 21))).astype(
        np.int32), int(rng.integers(2, 7))) for _ in range(n)]
    reqs[4] = (reqs[0][0].copy(), reqs[4][1])
    return reqs


def _serve(cls, model, params, reqs, extra, **kw):
    eng = cls(model, params, capacity=3, max_len=32, decode_chunk=2,
              **kw, **extra)
    handles = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    out = {"streams": {r.rid: list(r.out_tokens) for r in handles},
           "grant_log": list(eng.grant_log)}
    if eng.kv_layout == "paged":
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
        out["acquires"] = eng.pool.pages.lock_stats()["acquires"]
        out["prefix_hits"] = eng.stats()["prefix_hits"]
    return out


@pytest.mark.parametrize("layout", ["main", "slots"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_matches_reference(name, layout):
    jm, jp, tm, tp = models(name)
    kw = MAIN if layout == "main" else SLOTS
    reqs = _requests(sum(map(ord, name)))
    want = _serve(JEngine, jm, jp, reqs, {"seed": 0}, **kw)
    got = _serve(SlotServeEngine, tm, tp, reqs, {"device": "cpu"}, **kw)
    assert got == want
    assert all(len(s) == n for s, (_, n) in zip(got["streams"].values(),
                                                reqs))


def _serve_trace(cls, model, params, arrivals, extra):
    """Paged, one-shot prefill, sharing on: requests join at their
    rounds."""
    eng = cls(model, params, capacity=2, max_len=40, decode_chunk=2,
              kv_layout="paged", page_size=8, prefix_sharing="on",
              prefill_chunk_tokens=None, **extra)
    pending = list(arrivals)
    while pending or eng.queue or eng.active:
        while pending and pending[0][0] <= eng.step_clock:
            _, prompt, max_new = pending.pop(0)
            eng.submit(prompt, max_new)
        if eng.step() == 0 and not eng.queue and pending:
            eng.step_clock += 1
    eng.pool.check()
    assert eng.pool.pages.in_use == 0
    st = eng.stats()
    return {"streams": {r.rid: list(r.out_tokens) for r in eng.finished},
            "grant_log": list(eng.grant_log),
            "acquires": eng.pool.pages.lock_stats()["acquires"],
            **{k: st[k] for k in ("prefix_hits", "shared_pages_adopted",
                                  "cow_splits")}}


def test_leftover_layers_cow_split_matches_reference():
    """gemma3-1b with leftover layers: a 9-token prompt (past the window
    of 8) served twice, the second joining while the first still writes
    its partial page — the adopter splits the shared page, copying every
    layer's K/V, the leftover layers' among them."""
    jm, jp, tm, tp = models("gemma3-1b-leftover")
    prompt = np.random.default_rng(9).integers(1, 512, 9).astype(np.int32)
    arrivals = [(0, prompt, 10), (2, prompt.copy(), 10)]
    want = _serve_trace(JEngine, jm, jp, arrivals, {"seed": 0})
    got = _serve_trace(SlotServeEngine, tm, tp, arrivals, {"device": "cpu"})
    assert got == want
    assert got["prefix_hits"] == 1 and got["cow_splits"] >= 1
