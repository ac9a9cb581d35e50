"""Fault injection and round recovery in the port, held to the JAX
package (the reference's tests/test_faults.py, case for case, each
compared with the reference on the same inputs):

* ``FaultPlan`` draws, budgets, ``suspended`` and poison equal
  ``repro.serve.faults`` over seeds (one seed injects the same faults at
  the same points in both packages);
* ``alloc_batch`` / ``free_batch`` rolled back at every stage, equal to a
  clean pool, and a chaos pool granting what a clean pool grants;
* the allocator watchdog counting stuck holders (pool and engine);
* engine chaos and poison runs equal to the JAX engine's under the same
  plan: streams, states, ``grant_log``, acquires and lifecycle counts;
* the retry exactness test: a plain ``RuntimeError`` raised inside the
  port's decode after its first layer is retried, and the streams equal
  the fault-free run;
* the no-hiding test: the kernel layer's ``KernelError`` (or an error of
  the CUDA runtime), raised at the same point, leaves ``step`` at once
  with nothing retried or quarantined;
* the launcher's leak gate.

Reduced qwen3-14b, float32, the reference's weights through the bridge."""

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve import faults as jfaults
from repro.serve import kv_pages as jkv
from repro.serve.engine import SlotServeEngine as JEngine
from repro.serve.fuzz import drive_trace as jdrive_trace
from repro.serve.fuzz import gen_trace as jgen_trace
from repro_torch.configs import get_arch
from repro_torch.kernels.build import KernelError
from repro_torch.models import blocks, build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import faults as tfaults
from repro_torch.serve import kv_pages as tkv
from repro_torch.serve.engine import RequestState, SlotServeEngine
from repro_torch.serve.fuzz import drive_trace, gen_trace

#: every stage ``alloc_batch`` journals
ALLOC_STAGES = ("alloc:validated", "alloc:increfs", "alloc:evict_decrefs",
                "alloc:grant", "alloc:paired_decrefs")
LIFECYCLE = ("finished", "terminal", "cancelled", "expired", "failed",
             "faults_injected", "rounds_retried", "requests_quarantined",
             "aborted_batches", "lock_acquires", "decode_dispatches",
             "page_pauses", "page_preemptions")


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


# ============================================================ the plan
def _consult(plan, mod, k, site):
    try:
        if site == "alloc":
            plan.alloc_hook("alloc:grant")
        elif site == "dispatch":
            plan.dispatch([k, k + 1])
        else:
            plan.executor()
        return None
    except mod.InjectedFault as e:
        return (e.kind, e.rid, str(e))


@pytest.mark.parametrize("seed", [0, 3, 7, 31, 12345])
def test_fault_plan_draws_match_reference(seed):
    """The same schedule of consults gives the same faults, kinds, blamed
    rids, messages, budgets and stats in both packages, with per-kind
    caps, a global cap, and a suspended stretch that consumes no draw."""
    kw = dict(alloc_rate=0.3, dispatch_rate=0.25, executor_rate=0.2,
              stuck_rate=0.15, stuck_hold_s=0.0, max_faults=12,
              max_per_kind={"alloc": 4, "stuck": 2})
    logs, plans = [], []
    for mod in (jfaults, tfaults):
        plan = mod.FaultPlan(seed, **kw)
        log = []
        for k in range(60):
            if 20 <= k < 25:
                with plan.suspended():
                    log.append(_consult(plan, mod, k, "dispatch"))
                continue
            log.append(_consult(plan, mod, k,
                                ("alloc", "dispatch", "executor")[k % 3]))
        logs.append(log)
        plans.append(plan)
    assert logs[1] == logs[0]
    j, t = plans
    assert t.stats() == j.stats() and t._draws == j._draws
    assert t.stuck_holds == j.stuck_holds and t.injected <= 12


def test_fault_plan_suspension_and_poison_match_reference():
    for mod in (jfaults, tfaults):
        d = mod.FaultPlan(7, alloc_rate=0.3, dispatch_rate=0.2,
                          executor_rate=0.2)
        with d.suspended():
            for _ in range(10):
                d.alloc_hook("alloc:grant")
                d.dispatch([1])
                d.executor()
        assert d.injected == 0 and d._draws == {} and d.active
    out = []
    for mod in (jfaults, tfaults):
        fp = mod.FaultPlan(0, poison_rid=4, max_faults=2)
        got = [_consult(fp, mod, 3, "dispatch") for _ in range(3)]
        fp.dispatch([1, 9])          # poisoned rid absent: silent
        out.append((got, fp.stats()))
    assert out[1] == out[0]
    assert [g[1] if g else None for g in out[1][0]] == [4, 4, None]


# ==================================================== pool transactions
def _snapshot(pool):
    return {"free": list(pool._free),
            "allocated": pool._allocated.tolist(),
            "refcount": pool._refcount.tolist(),
            "epoch": pool._epoch.tolist(),
            **{k: getattr(pool, k) for k in (
                "allocs", "frees", "pages_alloced", "pages_freed",
                "increfs", "decrefs", "aborted_batches")},
            "grant_log": list(pool.grant_log)}


class _StageFault:
    """Raise the package's InjectedFault the first time ``stage`` fires."""

    def __init__(self, mod, stage):
        self.mod, self.stage, self.fired = mod, stage, 0

    def __call__(self, stage):
        if stage == self.stage:
            self.fired += 1
            if self.fired == 1:
                raise self.mod.InjectedFault("alloc", detail=stage)


@pytest.mark.parametrize("stage", ALLOC_STAGES)
def test_alloc_batch_rolls_back_at_every_stage(stage):
    """A fault at any journaled stage leaves the pool as it was (free-list
    order included) and the retry grants from the same FIFO head — the
    port's pool equal to the reference's at every point."""
    snaps = []
    for mod, kv in ((jfaults, jkv), (tfaults, tkv)):
        pool = kv.PagePool(16, 4)
        held = pool.alloc(3, tag="seed")
        shared = pool.alloc(2, tag="shared")
        before = _snapshot(pool)
        pool.fault_hook = _StageFault(mod, stage)
        with pytest.raises(mod.InjectedFault):
            pool.alloc_batch([2, 1], ["a", "b"], incref_groups=[held],
                             paired_decrefs=[held, None],
                             decref_groups=[shared])
        pool.fault_hook = None
        after = _snapshot(pool)
        assert after.pop("aborted_batches") == 1
        before.pop("aborted_batches")
        assert after == before
        pool.check()
        out = pool.alloc_batch([2, 1], ["a", "b"], incref_groups=[held],
                               paired_decrefs=[held, None],
                               decref_groups=[shared])
        assert pool.grant_log == ["seed", "shared", "a", "b"]
        pool.check()
        snaps.append(([g.tolist() for g in out], _snapshot(pool)))
    assert snaps[1] == snaps[0]


def test_free_batch_rolls_back_midway():
    snaps = []
    for mod, kv in ((jfaults, jkv), (tfaults, tkv)):
        pool = kv.PagePool(12, 4)
        a, b = pool.alloc(3, "a"), pool.alloc(2, "b")
        before = _snapshot(pool)
        pool.fault_hook = _StageFault(mod, "free:decrefs")
        with pytest.raises(mod.InjectedFault):
            pool.free_batch([a, b])
        pool.fault_hook = None
        after = _snapshot(pool)
        assert after.pop("aborted_batches") == 1
        before.pop("aborted_batches")
        assert after == before
        freed = pool.free_batch([a, b])
        assert sorted(freed) == sorted(a.tolist() + b.tolist())
        assert pool.in_use == 0
        snaps.append((freed, _snapshot(pool)))
    assert snaps[1] == snaps[0]


@pytest.mark.parametrize("seed", [5, 9])
def test_faulted_pool_grants_identically_to_clean_pool(seed):
    """Faulted (rolled back, then retried) batches interleaved with clean
    ones: every grant equals a never-faulted pool's, page ids included,
    and the port's chaos pool equals the reference's op by op."""
    runs = []
    for mod, kv in ((jfaults, jkv), (tfaults, tkv)):
        clean, chaos = kv.PagePool(24, 4), kv.PagePool(24, 4)
        fp = mod.FaultPlan(seed, alloc_rate=0.4)
        chaos.fault_hook = fp.alloc_hook
        rng = np.random.default_rng(2)
        live_clean, live_chaos, log = [], [], []
        for step in range(30):
            if live_clean and (clean.n_free < 4 or rng.random() < 0.4):
                i = int(rng.integers(len(live_clean)))
                clean.free_batch([live_clean.pop(i)])
                grp = live_chaos.pop(i)
                try:
                    chaos.free_batch([grp])
                except mod.InjectedFault:
                    with fp.suspended():
                        chaos.free_batch([grp])
            else:
                n = int(rng.integers(1, 4))
                g_clean = clean.alloc_batch([n], [step])[0]
                try:
                    g_chaos = chaos.alloc_batch([n], [step])[0]
                except mod.InjectedFault:
                    with fp.suspended():
                        g_chaos = chaos.alloc_batch([n], [step])[0]
                assert g_clean.tolist() == g_chaos.tolist()
                live_clean.append(g_clean)
                live_chaos.append(g_chaos)
                log.append(g_chaos.tolist())
            chaos.check()
        assert fp.injected > 0 and chaos.aborted_batches > 0
        assert list(chaos._free) == list(clean._free)
        runs.append((log, fp.stats(), _snapshot(chaos)))
    assert runs[1] == runs[0]


def test_stuck_holder_trips_the_watchdog():
    """A slow holder (an injected sleep inside the critical section)
    trips the armed watchdog and completes."""
    pool = tkv.PagePool(8, 4, watchdog_s=0.002)
    fp = tfaults.FaultPlan(0, stuck_rate=1.0, stuck_hold_s=0.01,
                           max_faults=2)
    pool.fault_hook = fp.alloc_hook
    g = pool.alloc(2, "slow")
    assert fp.stuck_holds > 0
    assert pool.lock_stats()["watchdog_trips"] >= 1
    pool.fault_hook = None
    pool.free_batch([g])
    pool.check()
    assert tkv.PagePool(8, 4).mutex.watchdog_threshold_s is None


# ===================================================== engine recovery
def _engine(cls, model, params, extra, fault_plan, **kw):
    args = dict(capacity=3, max_len=128, kv_layout="paged", page_size=4,
                prefix_cache="on", prefill_chunk_tokens=4, decode_chunk=2,
                fault_plan=fault_plan, quarantine_after=3,
                retry_backoff_s=0.0)
    args.update(kw)
    return cls(model, params, **args, **extra)


def _trace_run(cls, model, params, extra, fault_plan, gen, drive, seed=7):
    events = gen(seed, n_requests=6, vocab=512, max_prompt=12, max_new=6,
                 p_cancel=0.0)
    eng = _engine(cls, model, params, extra, fault_plan)
    res = drive(eng, events)
    st = eng.stats()
    failed = sorted((r.rid, r.error) for r in eng.finished
                    if r.state.value == "failed")
    eng.drop_prefix_cache()
    eng.pool.check()
    assert eng.pool.pages.in_use == 0
    return {"streams": {k: (v["out"], v["cancelled"]) for k, v in
                        res.items()},
            "grant_log": list(eng.grant_log),
            "failed_rids": failed,
            **{k: st[k] for k in LIFECYCLE},
            "by_kind": dict(fault_plan.by_kind) if fault_plan else {}}


def _both_traces(models, make_plan):
    jm, jp, tm, tp = models
    want = _trace_run(JEngine, jm, jp, {"seed": 0}, make_plan(jfaults),
                      jgen_trace, jdrive_trace)
    got = _trace_run(SlotServeEngine, tm, tp, {"device": "cpu"},
                     make_plan(tfaults), gen_trace, drive_trace)
    assert got == want
    return got


def test_engine_chaos_matches_reference(models):
    """Allocator aborts and dispatch failures: the same faults fire at the
    same points as in the JAX engine, every round commits or rolls back
    and retries, and all streams equal the fault-free run's."""
    _, _, tm, tp = models
    base = _trace_run(SlotServeEngine, tm, tp, {"device": "cpu"}, None,
                      gen_trace, drive_trace)
    assert base["faults_injected"] == 0 and base["rounds_retried"] == 0
    got = _both_traces(models, lambda mod: mod.FaultPlan(
        31, alloc_rate=0.08, dispatch_rate=0.05))
    assert got["faults_injected"] > 0 and got["rounds_retried"] > 0
    assert got["aborted_batches"] > 0 and got["requests_quarantined"] == 0
    assert got["streams"] == base["streams"]


def test_engine_poison_matches_reference(models):
    """A request that fails every round it is in ends FAILED after
    ``quarantine_after`` consecutive failures, alone; every other stream
    equals the fault-free run's."""
    _, _, tm, tp = models
    base = _trace_run(SlotServeEngine, tm, tp, {"device": "cpu"}, None,
                      gen_trace, drive_trace)
    got = _both_traces(models, lambda mod: mod.FaultPlan(0, poison_rid=2))
    assert got["requests_quarantined"] == 1 and got["failed_rids"][0][0] == 2
    assert "injected fault" in got["failed_rids"][0][1]
    assert got["rounds_retried"] >= 3
    # the trace's rids are not the engine's: the failed one is the single
    # stream drive_trace marks torn down
    survivors = {k: v for k, v in got["streams"].items() if not v[1]}
    assert len(survivors) == len(base["streams"]) - 1
    assert survivors == {k: base["streams"][k] for k in survivors}


def test_engine_watchdog_counts_stuck_holders(models):
    """``allocator_watchdog_s`` arms the allocator's mutex: stuck holders
    surface as ``watchdog_trips`` and the run finishes (slow, not broken),
    its streams and counts equal to the JAX engine's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, 6).astype(np.int32) for _ in range(2)]
    out = []
    for cls, m, p, extra, mod in ((JEngine, jm, jp, {"seed": 0}, jfaults),
                                  (SlotServeEngine, tm, tp,
                                   {"device": "cpu"}, tfaults)):
        fp = mod.FaultPlan(1, stuck_rate=1.0, stuck_hold_s=0.01,
                           max_faults=3)
        eng = cls(m, p, capacity=2, max_len=64, kv_layout="paged",
                  page_size=4, decode_chunk=2, fault_plan=fp,
                  allocator_watchdog_s=0.002, **extra)
        reqs = [eng.submit(q, 4) for q in prompts]
        eng.run_until_done()
        st = eng.stats()
        assert fp.stuck_holds > 0 and st["watchdog_trips"] >= 1
        out.append(([list(r.out_tokens) for r in reqs], fp.stats(),
                    st["finished"], list(eng.grant_log)))
    assert out[1] == out[0] and out[1][2] == 2


# ============================================ retry exactness, no hiding
class _RaiseInDecode:
    """Wraps ``blocks.block_decode``: raises ``make_exc()`` once, on call
    ``at`` (1-based) — with 2 layers and decode chunk 2, call 8 is the
    second layer of the second decode step of a round."""

    def __init__(self, inner, at, make_exc):
        self.inner, self.at, self.make_exc = inner, at, make_exc
        self.calls = self.raised = 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls == self.at and not self.raised:
            self.raised += 1
            raise self.make_exc()
        return self.inner(*a, **kw)


RETRY_CONFIGS = {
    "paged_chunked_bucketed": dict(kv_layout="paged", page_size=4,
                                   prefill_chunk_tokens=4,
                                   attention_impl="fused"),
    "paged_oneshot_sharing": dict(kv_layout="paged", page_size=4,
                                  prefix_sharing="on"),
    "slots_oneshot": dict(kv_layout="slots"),
}


def _serve(tm, tp, kw, reqs):
    eng = SlotServeEngine(tm, tp, capacity=2, max_len=32, decode_chunk=2,
                          retry_backoff_s=0.0, device="cpu", **kw)
    handles = [eng.submit(p, n) for p, n in reqs]
    return eng, handles


def _requests():
    rng = np.random.default_rng(4)
    return [(rng.integers(1, 512, int(rng.integers(5, 12))).astype(np.int32),
             int(rng.integers(4, 8))) for _ in range(4)]


@pytest.mark.parametrize("config", sorted(RETRY_CONFIGS))
@pytest.mark.parametrize("at", [2, 8, 14])
def test_retry_after_a_partial_dispatch_replays_the_round(models, config,
                                                          at, monkeypatch):
    """A plain ``RuntimeError`` raised inside the decode after its first
    layer, once the round has written K/V: the round is retried and the
    streams, grant log and step counts equal the fault-free run's (no
    host state moved before the dispatch returned; the arena writes it
    made are rewritten with the same values)."""
    _, _, tm, tp = models
    kw, reqs = RETRY_CONFIGS[config], _requests()
    eng, hs = _serve(tm, tp, kw, reqs)
    eng.run_until_done()
    base = ([list(h.out_tokens) for h in hs], list(eng.grant_log),
            eng.decode_steps_run, eng.decode_dispatches, eng.step_clock)
    wrap = _RaiseInDecode(blocks.block_decode, at,
                          lambda: RuntimeError("host fault mid-round"))
    monkeypatch.setattr(blocks, "block_decode", wrap)
    eng, hs = _serve(tm, tp, kw, reqs)
    eng.run_until_done()
    assert wrap.raised == 1
    got = ([list(h.out_tokens) for h in hs], list(eng.grant_log),
           eng.decode_steps_run, eng.decode_dispatches, eng.step_clock)
    assert got == base
    st = eng.stats()
    assert st["rounds_retried"] == 1 and st["requests_quarantined"] == 0
    assert all(h.state is RequestState.FINISHED for h in hs)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.pages.in_use == 0


@pytest.mark.parametrize("make_exc", [
    lambda: KernelError("paged_decode_launch: CUDA error 719 (launch "
                        "failure)"),
    lambda: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
], ids=["kernel_error", "runtime_error"])
@pytest.mark.parametrize("config", sorted(RETRY_CONFIGS))
def test_kernel_and_device_errors_are_not_retried(models, config, make_exc,
                                                monkeypatch):
    """The same point of failure with an error of the kernel layer or of
    the CUDA runtime: ``step`` raises it at once — no round retried, no
    request blamed, quarantined or failed — so a fault of the card is
    never absorbed as a round failure."""
    _, _, tm, tp = models
    wrap = _RaiseInDecode(blocks.block_decode, 8, make_exc)
    monkeypatch.setattr(blocks, "block_decode", wrap)
    eng, hs = _serve(tm, tp, RETRY_CONFIGS[config], _requests())
    kind = type(make_exc())
    with pytest.raises(kind) as ei:
        eng.run_until_done()
    assert str(ei.value) == str(make_exc())
    st = eng.stats()
    assert st["rounds_retried"] == 0 and st["requests_quarantined"] == 0
    assert st["failed"] == 0 and eng._round_failures == {}
    assert not any(h.state is RequestState.FAILED for h in hs)


# ======================================================= launch leak gate
def test_launch_leak_gate_fails_loudly_on_leak(models, capsys):
    """The launcher's post-drain gate passes a drained engine and exits
    non-zero on a page held past the drain."""
    from repro_torch.launch.serve import enforce_leak_gate
    _, _, tm, tp = models
    eng = _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, None)
    enforce_leak_gate(eng)
    assert "leak check: OK" in capsys.readouterr().out
    eng.pool.pages.alloc(1)
    with pytest.raises(SystemExit) as ei:
        enforce_leak_gate(eng)
    assert ei.value.code == 1
    assert "FATAL" in capsys.readouterr().out
