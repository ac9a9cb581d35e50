"""Temperature sampling in the port's engines, on the CPU.

The port draws from ``softmax(logits / T)`` by the Gumbel-max rule with
an explicit ``torch.Generator``; the reference draws with
``jax.random.categorical`` from its own key. The two random streams
differ, so sampled token streams are held to the port's own seeds and
to the distribution, and what the two packages share is held to the
reference: every gate a sampling engine resolves (eager growth, no
chunked prefill, no sharing or cache under ``auto``, full-batch
dispatch) on reduced qwen3-14b and on reduced falcon-mamba-7b.

Also: at T 1e-3 on logits with a margin of 1 the draws are the argmax;
1e5 seeded draws over 16 categories lie within 5e-3 of ``softmax(logits
/ T)`` in every category (5e-3 is 3.16 standard deviations of a
frequency of 1e5 draws in the worst case, p = 1/2); the same seed
serves the same streams and another seed other streams, in the slot
engine and the legacy ``generate``; a run whose dispatches fail and are
retried serves the fault-free run's streams, since the retry replays
the generator from where the failed dispatch took it; eos freezes a
sampled row."""

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
from repro_torch.serve.engine import ServeEngine, SlotServeEngine, _sample
from repro_torch.serve.faults import FaultPlan
from test_torch_ssm_engine import GATE_TABLE, resolve
from test_torch_ssm_families import models as ssm_models

T = 0.8
FREQ_DRAWS = 100_000
FREQ_BOUND = 5e-3


@pytest.fixture(scope="module")
def qwen():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("kw", GATE_TABLE,
                         ids=[str(i) for i in range(len(GATE_TABLE))])
def test_sampling_gates_resolve_as_reference(qwen, kw):
    jm, jp, tm, tp = qwen
    kw = dict(kw, temperature=T)
    want = resolve(JEngine, jm, jp, kw, {})
    got = resolve(SlotServeEngine, tm, tp, kw, {"device": "cpu"})
    assert got == want
    if got[0] != "raises":
        assert got[:5] == ("eager", 0, False,
                           kw.get("prefix_sharing") == "on",
                           kw.get("prefix_cache") == "on")


def test_sampling_gates_on_a_recurrent_model():
    jm, jp, tm, tp = ssm_models("falcon-mamba-7b")
    for kw in (dict(kv_layout="paged", prefill_chunk_tokens=4),
               dict(kv_layout="slots")):
        kw = dict(kw, temperature=T)
        assert resolve(SlotServeEngine, tm, tp, kw, {"device": "cpu"}) == \
            resolve(JEngine, jm, jp, kw, {})


def test_greedy_gates_unchanged(qwen):
    """At temperature 0 an attention model keeps lazy growth, chunking,
    bucketing and sharing, as the reference does."""
    jm, jp, tm, tp = qwen
    kw = dict(kv_layout="paged", prefill_chunk_tokens=4)
    got = resolve(SlotServeEngine, tm, tp, kw, {"device": "cpu"})
    assert got == resolve(JEngine, jm, jp, kw, {})
    assert got[:5] == ("lazy", 4, True, True, False)


def test_low_temperature_draws_are_the_argmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 100)).astype(
        np.float32))
    top = logits.argmax(dim=-1)
    logits[torch.arange(64), top] = logits.max(dim=-1).values + 1.0
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        assert torch.equal(_sample(logits, 1e-3, gen), top.to(torch.int32))
    assert torch.equal(_sample(logits, 0.0, None), top.to(torch.int32))


def test_draw_frequencies_follow_the_softmax():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        16).astype(np.float32) * 2)
    gen = torch.Generator().manual_seed(0)
    draws = _sample(logits[None].expand(FREQ_DRAWS, 16), T, gen)
    freq = torch.bincount(draws.long(), minlength=16).double() / FREQ_DRAWS
    p = torch.softmax(logits.double() / T, dim=-1)
    assert float((freq - p).abs().max()) < FREQ_BOUND


def _serve(model, params, reqs, seed, **kw):
    eng = SlotServeEngine(model, params, capacity=3, max_len=32,
                          decode_chunk=2, temperature=T, seed=seed,
                          device="cpu", **kw)
    hs = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    if eng.kv_layout == "paged":
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
    assert all(h.state.value == "finished" for h in hs)
    return [list(h.out_tokens) for h in hs], eng.stats()


def _requests(seed, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(rng.integers(3, 15))).astype(
        np.int32), int(rng.integers(3, 8))) for _ in range(n)]


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_same_seed_same_streams(qwen, layout):
    _, _, tm, tp = qwen
    reqs = _requests(2)
    a, _ = _serve(tm, tp, reqs, 0, kv_layout=layout)
    b, _ = _serve(tm, tp, reqs, 0, kv_layout=layout)
    c, _ = _serve(tm, tp, reqs, 1, kv_layout=layout)
    assert a == b
    assert a != c
    assert [len(s) for s in a] == [n for _, n in reqs]


def test_dispatch_faults_replay_the_same_draws(qwen):
    """Dispatch failures (no allocator aborts: an aborted admission
    requeues its request, which moves its prefill draw) retried until
    they pass: every stream equals the fault-free run's."""
    _, _, tm, tp = qwen
    reqs = _requests(3)
    clean, _ = _serve(tm, tp, reqs, 0, kv_layout="paged")
    plan = FaultPlan(11, dispatch_rate=0.3)
    faulty, st = _serve(tm, tp, reqs, 0, kv_layout="paged",
                        fault_plan=plan, retry_backoff_s=0.0,
                        quarantine_after=1000)
    assert st["rounds_retried"] >= 1 and plan.by_kind.get("dispatch", 0)
    assert st["requests_quarantined"] == 0
    assert faulty == clean


def test_sampled_recurrent_model_serves():
    """A mamba model sampled on the paged layout: deterministic by seed,
    every request finished, no page leaked."""
    _, _, tm, tp = ssm_models("jamba-1.5-large-398b-4")
    reqs = [(np.arange(1, 6, dtype=np.int32), 4),
            (np.arange(7, 16, dtype=np.int32), 3)]
    a, _ = _serve(tm, tp, reqs, 0, kv_layout="paged", page_size=4)
    b, _ = _serve(tm, tp, reqs, 0, kv_layout="paged", page_size=4)
    assert a == b and [len(s) for s in a] == [4, 3]


def test_eos_freezes_a_sampled_row(qwen):
    """With eos set to a row's first sampled token, that request stops
    at once; the others run to their budget."""
    _, _, tm, tp = qwen
    reqs = _requests(4, n=3)
    streams, _ = _serve(tm, tp, reqs, 0, kv_layout="slots")
    eos = streams[0][0]
    eng = SlotServeEngine(tm, tp, capacity=3, max_len=32, decode_chunk=2,
                          temperature=T, seed=0, eos_id=eos, device="cpu",
                          kv_layout="slots")
    hs = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    assert hs[0].out_tokens == [eos] and hs[0].eos
    for h, s in zip(hs[1:], streams[1:]):
        if eos not in s:
            assert h.out_tokens == s


def test_legacy_generate_samples_by_seed(qwen):
    _, _, tm, tp = qwen
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (2, 7)).astype(np.int32))
    eng = ServeEngine(tm, tp, max_len=32, temperature=T)

    def run(seed):
        return eng.generate({"tokens": tok}, 6, generator=torch.Generator(
        ).manual_seed(seed)).tokens.tolist()

    assert run(0) == run(0) == eng.generate({"tokens": tok}, 6).tokens.tolist()
    assert run(0) != run(1)
    greedy = ServeEngine(tm, tp, max_len=32).generate({"tokens": tok}, 6)
    assert run(0) != greedy.tokens.tolist()
    assert np.asarray(run(0)).shape == (2, 6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode and admission kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


def test_cuda_sampled_streams_repeat_and_replay(cuda_device):
    """On the card (Philox): one seed serves the same streams twice, and
    a run with dispatch failures retried serves them too."""
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = tm.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    reqs = _requests(3)
    kw = dict(kv_layout="paged", attention_impl="fused")
    eng_kw = dict(device="cuda")
    a = _serve_on(tm, tp, reqs, 0, eng_kw, **kw)
    b = _serve_on(tm, tp, reqs, 0, eng_kw, **kw)
    plan = FaultPlan(11, dispatch_rate=0.3)
    f = _serve_on(tm, tp, reqs, 0, eng_kw, fault_plan=plan,
                  retry_backoff_s=0.0, quarantine_after=1000, **kw)
    assert a == b == f and plan.by_kind.get("dispatch", 0)


def _serve_on(model, params, reqs, seed, eng_kw, **kw):
    eng = SlotServeEngine(model, params, capacity=3, max_len=32,
                          decode_chunk=2, temperature=T, seed=seed,
                          **eng_kw, **kw)
    hs = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_done()
    assert all(h.state.value == "finished" for h in hs)
    return [list(h.out_tokens) for h in hs]
