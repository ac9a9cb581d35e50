"""The port's engines serving the recurrent decoders, reduced, on the CPU,
against the JAX engines on the same seeded requests and bridged weights:
falcon-mamba-7b, jamba-1.5-large-398b (8 layers) and jamba at 4 layers
(models of tests/test_torch_ssm_families.py).

``SlotServeEngine`` on the main path's arguments (paged, page size 4,
chunked prefill of 4 asked for, fused decode attention, bucketed
dispatch and prefix sharing ``auto``) and on the reference launcher's
default (the contiguous slot arena): greedy streams, the FIFO
``grant_log``, the allocator's acquires and the settings each engine
resolved must be identical — a model with a mamba layer prefills at the
exact prompt length, grows eagerly, never chunks, shares nothing and
dispatches the full batch — and both pools drain to no page in use. The
legacy ``ServeEngine`` on two requests. Then a table of constructor
arguments whose resolved gates equal the JAX engine's, and whose raising
cases raise in both. Prompts take three lengths only: the reference
compiles its exact-length prefill once per length."""

import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.serve.engine import ServeEngine, SlotServeEngine
from test_torch_ssm_families import SSM, models

MAIN = dict(kv_layout="paged", page_size=4, prefill_chunk_tokens=4,
            attention_impl="fused", bucketed_dispatch="auto",
            prefix_sharing="auto")
SLOTS = dict(kv_layout="slots", prefill_chunk_tokens=None)
LENGTHS = (5, 9, 12)


def _requests(seed, n=5):
    """n prompts of 5, 9 or 12 tokens with 2-6 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=LENGTHS[i % 3]).astype(np.int32),
             int(rng.integers(2, 7))) for i in range(n)]


def gates(eng):
    """The settings an engine resolved from its arguments."""
    return (eng.page_growth, eng.prefill_chunk, bool(eng.bucketed_dispatch),
            bool(eng.prefix_sharing), eng.prefix_cache is not None,
            eng.round_token_budget)


def _serve(cls, model, params, reqs, extra, **kw):
    eng = cls(model, params, capacity=3, max_len=32, decode_chunk=2,
              **kw, **extra)
    handles = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    out = {"streams": {r.rid: list(r.out_tokens) for r in handles},
           "grant_log": list(eng.grant_log), "gates": gates(eng),
           "finished": eng.stats()["finished"]}
    if eng.kv_layout == "paged":
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
        out["acquires"] = eng.pool.pages.lock_stats()["acquires"]
    return out


@pytest.mark.parametrize("layout", ["main", "slots"])
@pytest.mark.parametrize("name", SSM)
def test_engine_matches_reference(name, layout):
    jm, jp, tm, tp = models(name)
    kw = MAIN if layout == "main" else SLOTS
    reqs = _requests(sum(map(ord, name)))
    want = _serve(JEngine, jm, jp, reqs, {"seed": 0}, **kw)
    got = _serve(SlotServeEngine, tm, tp, reqs, {"device": "cpu"}, **kw)
    assert got == want
    assert got["gates"][:5] == ("eager", 0, False, False, False)
    assert got["finished"] == len(reqs)
    assert all(len(s) == n for s, (_, n) in zip(got["streams"].values(),
                                                reqs))


@pytest.mark.parametrize("name", SSM)
def test_exact_length_prefill_pads_nothing(name):
    """``pad_prompts_to`` and the power-of-2 bucket are ignored: every
    prompt token prefilled is real."""
    _, _, tm, tp = models(name)
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=32, pad_prompts_to=16,
                          device="cpu", **MAIN)
    for p, n in _requests(1, n=3):
        eng.submit(p, n)
    eng.run_until_done()
    st = eng.stats()
    assert eng._bucket_len(5) == 5
    assert st["pad_tokens"] == 0 and st["prefill_tokens"] == 5 + 9 + 12


@pytest.mark.parametrize("name", SSM)
def test_legacy_engine_matches_reference(name):
    """The legacy loop on two 9-token prompts, 4 greedy tokens each."""
    import jax.numpy as jnp
    jm, jp, tm, tp = models(name)
    tok = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    want = JServeEngine(jm, jp, max_len=16).generate(
        {"tokens": jnp.asarray(tok)}, 4).tokens
    got = ServeEngine(tm, tp, max_len=16).generate(
        {"tokens": torch.from_numpy(tok)}, 4).tokens
    assert got.tolist() == np.asarray(want).tolist()


GATE_TABLE = [
    dict(kv_layout="paged"),
    dict(kv_layout="paged", prefill_chunk_tokens=4),
    dict(kv_layout="paged", page_growth="lazy", prefill_chunk_tokens=4),
    dict(kv_layout="paged", bucketed_dispatch="off"),
    dict(kv_layout="paged", bucketed_dispatch="on"),
    dict(kv_layout="paged", prefix_sharing="on", prefix_cache="on"),
    dict(kv_layout="paged", prefix_sharing="off", prefix_cache="auto"),
    dict(kv_layout="paged", prefix_sharing="auto", prefix_cache="auto",
         round_token_budget=7),
    dict(kv_layout="slots"),
    dict(kv_layout="slots", prefill_chunk_tokens=4),
    dict(kv_layout="slots", bucketed_dispatch="on"),
    dict(kv_layout="slots", prefix_sharing="on"),
    dict(kv_layout="slots", prefix_cache="auto"),
    dict(kv_layout="paged", attention_impl="fused",
         prefill_chunk_tokens=8),
]


def resolve(cls, model, params, kw, extra):
    """The resolved gates, or the error's type and message."""
    try:
        return gates(cls(model, params, capacity=2, max_len=16,
                         page_size=4, **kw, **extra))
    except ValueError as exc:
        return ("raises", str(exc))


@pytest.mark.parametrize("kw", GATE_TABLE,
                         ids=[str(i) for i in range(len(GATE_TABLE))])
@pytest.mark.parametrize("name", ["falcon-mamba-7b",
                                  "jamba-1.5-large-398b-4"])
def test_gates_resolve_as_reference(name, kw):
    jm, jp, tm, tp = models(name)
    want = resolve(JEngine, jm, jp, kw, {})
    got = resolve(SlotServeEngine, tm, tp, kw, {"device": "cpu"})
    assert got == want
    if kw.get("bucketed_dispatch") == "on":
        assert got[0] == "raises"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode and admission kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("layout", ["main", "slots"])
@pytest.mark.parametrize("name", SSM)
def test_cuda_engine_matches_cpu(cuda_device, name, layout):
    """The port on the card (its kernels) against the port on the CPU
    (their plain versions), same weights and requests: streams, grants,
    acquires and gates identical."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = get_arch(name.removesuffix("-4")).reduced()
    if name.endswith("-4"):
        cfg = dataclasses.replace(cfg, num_layers=4)
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    kw = MAIN if layout == "main" else SLOTS
    reqs = _requests(3)
    want = _serve(SlotServeEngine, tm, tp, reqs, {"device": "cpu"}, **kw)
    got = _serve(SlotServeEngine, tm, tree_map(lambda t: t.to("cuda"), tp),
                 reqs, {"device": "cuda"}, **kw)
    assert got == want
