"""Seeded lifecycle traces and the pool fuzz harness in the port, held
to the JAX package (the reference's tests/test_trace_fuzz.py and the
fuzz case of tests/test_faults.py), and the launcher's open loop and
chaos mode:

* ``gen_trace`` equal to ``repro.serve.fuzz.gen_trace`` over seeds and
  settings;
* ``PoolFuzzHarness`` over the port's ``PagePool`` and ``PrefixCache``:
  its audits pass on seeded traces (cache on and off, a tight arena,
  allocator faults), and the pool, cache and recovery counts after each
  run equal the reference harness's on the same seed;
* ``drive_trace`` on the port's engine equal to the JAX engine's on two
  seeds (shared prompts, multi-turn follow-ups, cancellations, the
  prefix cache on);
* ``launch/serve.py --open-loop`` and ``--fault-rate`` on ``--device cpu
  --smoke``: the report's keys equal the reference launcher's, every
  client is accounted for, and the leak gate passes.

Reduced qwen3-14b, float32, the reference's weights through the bridge."""

import argparse

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve import faults as jfaults
from repro.serve import fuzz as jfuzz
from repro.serve.engine import SlotServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fuzz as tfuzz
from repro_torch.serve.engine import SlotServeEngine


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _events(evs):
    return [(e.rid, e.prompt.tolist(), e.max_new_tokens, e.submit_round,
             e.cancel_after, e.turn_of) for e in evs]


# ================================================================ traces
@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2 ** 31 - 1])
@pytest.mark.parametrize("kw", [
    {}, dict(n_requests=20, vocab=512, max_prompt=40, max_new=12),
    dict(n_system_prompts=1, p_shared=0.9, p_multi_turn=0.6, p_cancel=0.5,
         arrival_spread=1)], ids=["defaults", "long", "colliding"])
def test_gen_trace_matches_reference(seed, kw):
    assert _events(tfuzz.gen_trace(seed, **kw)) == \
        _events(jfuzz.gen_trace(seed, **kw))


# ============================================================ pool fuzz
def _harness_state(h):
    pool = h.pool
    out = {"free": list(pool._free), "refcount": pool._refcount.tolist(),
           "grant_log": list(pool.grant_log),
           "counts": (pool.allocs, pool.frees, pool.pages_alloced,
                      pool.pages_freed, pool.increfs, pool.decrefs,
                      pool.aborted_batches),
           "admit_order": list(h.admit_order), "rounds": h.rounds,
           "recovered": h.aborts_recovered}
    if h.cache is not None:
        out["cache"] = h.cache.stats()
    return out


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_pool_fuzz_seeded_traces(cache):
    """Seeded admit / grow / retire-donate / evict lifecycles, invariants
    audited every round, drained leak-free."""
    for seed in range(40):
        h = tfuzz.PoolFuzzHarness(seed, num_pages=48, page_size=4,
                                  cache=cache)
        h.run(rounds=30)
        assert h.pool.in_use == 0


@pytest.mark.parametrize("seed", [0, 5, 11, 1003])
@pytest.mark.parametrize("shape", [
    dict(num_pages=48, page_size=4, cache=True),
    dict(num_pages=16, page_size=4, cache=True, watermark_pages=3),
    dict(num_pages=24, page_size=2, cache=False)],
    ids=["roomy", "tight", "no_cache"])
def test_pool_fuzz_matches_reference(seed, shape):
    """The same seed drives the same lifecycle over both packages' pools
    and caches: every count, the free list and the grant log equal."""
    hs = []
    for fz in (jfuzz, tfuzz):
        h = fz.PoolFuzzHarness(seed, **shape)
        h.run(rounds=40)
        hs.append(_harness_state(h))
    assert hs[1] == hs[0]


def test_pool_fuzz_tight_arena_forces_eviction():
    evicted = 0
    for seed in range(20):
        h = tfuzz.PoolFuzzHarness(1000 + seed, num_pages=16, page_size=4,
                                  cache=True, watermark_pages=3)
        h.run(rounds=40)
        evicted += h.cache.pages_evicted
    assert evicted > 0


def test_pool_fuzz_with_allocator_faults_matches_reference():
    """Injected allocator aborts are recovered (rollback, then the
    planned evictions replayed) and the arena drains empty; the same
    faults and recoveries as the reference harness, seed for seed."""
    injected = recovered = 0
    for seed in range(20):
        states = []
        for fz, fm in ((jfuzz, jfaults), (tfuzz, tfaults)):
            fp = fm.FaultPlan(seed, alloc_rate=0.1)
            h = fz.PoolFuzzHarness(seed, num_pages=48, page_size=4,
                                   cache=True, faults=fp)
            h.run(rounds=30)
            assert h.pool.in_use == 0
            states.append((_harness_state(h), fp.stats()))
        assert states[1] == states[0]
        injected += states[1][1]["faults_injected"]
        recovered += states[1][0]["recovered"]
    assert injected > 0 and recovered > 0


# ======================================================== engine traces
@pytest.mark.parametrize("seed", [0, 1])
def test_drive_trace_matches_reference(models, seed):
    """A seeded trace (shared system prompts, multi-turn follow-ups
    resolved against the real replies, cancellations) served by both
    engines with the prefix cache on: every stream, cancellation flag,
    resolved prompt, the grant log and the counts equal."""
    jm, jp, tm, tp = models
    outs = []
    for cls, m, p, extra, fz in ((JEngine, jm, jp, {"seed": 0}, jfuzz),
                                 (SlotServeEngine, tm, tp,
                                  {"device": "cpu"}, tfuzz)):
        events = fz.gen_trace(seed, n_requests=6, vocab=512, max_prompt=12,
                              max_new=6, p_cancel=0.15)
        eng = cls(m, p, capacity=3, max_len=128, kv_layout="paged",
                  page_size=4, prefix_cache="on", prefill_chunk_tokens=4,
                  decode_chunk=2, **extra)
        rounds = {}
        res = fz.drive_trace(eng, events, stats_out=rounds)
        st = eng.stats()
        eng.drop_prefix_cache()
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
        outs.append(({k: (v["prompt"].tolist(), v["out"], v["cancelled"])
                      for k, v in res.items()}, list(eng.grant_log), rounds,
                     {k: st[k] for k in ("finished", "cancelled",
                                         "cache_hits", "prefix_hits",
                                         "lock_acquires")}))
    assert outs[1] == outs[0]
    assert outs[1][1] == sorted(outs[1][1])


# ============================================================ launcher
LAUNCH = ["--arch", "qwen3-14b", "--smoke", "--requests", "6",
          "--capacity", "2", "--prompt-len", "8", "--new-tokens", "3",
          "--kv-layout", "paged", "--page-size", "4",
          "--arrival-rate", "500", "--cancel-rate", "0.3",
          "--slo-ms", "5000", "--intake-limit", "3", "--deadline-ms",
          "60000"]


def test_open_loop_report_keys_match_reference(models):
    """The open-loop report carries the reference launcher's keys, every
    client is accounted for, and the drain leaves no page in use."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch
    jm, jp, tm, tp = models
    targs = tlaunch.parser().parse_args(LAUNCH + ["--open-loop",
                                                  "--device", "cpu"])
    prompts = tlaunch.make_prompts(targs, 512)
    records = []
    eng, _, got = tlaunch.run_open_loop(tm, tp, prompts, targs, "cpu",
                                        records=records)
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items()
                                  if k != "device"})
    jargs.sync_backend = "auto"
    _, _, want = jlaunch.run_open_loop(jm, jp, prompts, jargs)
    assert set(got) == set(want)
    assert all(isinstance(got[k], type(want[k])) for k in want)
    assert got["leaked_pages"] == 0 and len(records) == 6
    st = eng.stats()
    assert (got["finished"] + got["cancelled"] + got["expired"]
            + got["shed"] + int(st["failed"])) == 6
    for r in records:
        if r["handle"] is not None:
            assert r["tokens"] == r["handle"].out_tokens


@pytest.mark.parametrize("mode", [["--open-loop"], []],
                         ids=["open_loop", "closed_loop"])
def test_launcher_chaos_mode_on_the_cpu(mode, capsys):
    """``--fault-rate`` with ``--fault-seed``: faults fire, every one is
    recovered, and the post-drain leak gate passes."""
    from repro_torch.launch import serve as tlaunch
    eng = tlaunch.main(LAUNCH + mode + ["--device", "cpu", "--fault-rate",
                                        "0.3", "--fault-seed", "1"])
    out = capsys.readouterr().out
    assert "leak check: OK" in out and "chaos (seed 1, rate 0.3)" in out
    st = eng.stats()
    assert st["faults_injected"] > 0 and st["failed"] == 0
    assert eng.fault_plan.seed == 1 and eng.pool.pages.in_use == 0
    if mode:
        assert "open loop:" in out
    else:
        assert st["finished"] == 6


def test_launcher_builds_the_sync_library_from_flags():
    from repro_torch.launch import serve as tlaunch
    args = tlaunch.parser().parse_args(
        ["--arch", "qwen3-14b", "--sync-backend", "ref",
         "--admission-sem", "spin"])
    lib = tlaunch.make_sync_library(args)
    assert lib.backend == "ref" and lib.semaphore_kind == "spin"
    assert type(lib.semaphore(2)).__name__ == "SpinSemaphore"
    auto = tlaunch.make_sync_library(tlaunch.parser().parse_args(
        ["--arch", "qwen3-14b"]))
    assert auto.backend is None and auto.semaphore_kind is None
    assert tlaunch.make_fault_plan(args) is None
