"""The request lifecycle in the port, held to the JAX package (the
reference's tests/test_frontend.py engine half and
tests/test_prefix_cache.py::test_cancelled_request_still_donates_written_prefix):

* cancellation in QUEUED, PREFILLING and DECODING on the slot arena, the
  paged arena and the paged arena with prefix sharing: states, streams,
  ``grant_log``, acquires and lifecycle counts equal to the JAX engine's,
  survivors equal to a run with no cancellation, no page leaked;
* a request cancelled mid-prefill donates its written pages to the
  prefix cache, and a resubmission adopts them;
* a queued request past its step deadline expires before admission; a
  late row evicted under page pressure expires rather than requeues;
  the time-in-state ledger partitions each lifetime (``stats`` and
  ``slot_deadlines`` equal to the reference's);
* ``SyncLibrary.acquire`` / ``try_acquire`` / ``SyncTimeoutError``, the
  ``FutexMutex`` and ``make_mutex`` / ``make_semaphore``, outcome for
  outcome equal to ``repro.sync`` and ``repro.core.hostsync``.

Reduced qwen3-14b, float32, the reference's weights through the bridge.
Every thread is joined with a timeout and must have ended; every timed
wait has a holder that releases."""

import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.core import hostsync as jhs
from repro.models import build_model as jbuild
from repro.serve.engine import SlotServeEngine as JEngine
from repro.sync import SyncLibrary as JSyncLibrary
from repro.sync import SyncTimeoutError as JSyncTimeoutError
from repro_torch.configs import get_arch
from repro_torch.core import hostsync as ths
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import RequestState, SlotServeEngine
from repro_torch.sync import SyncLibrary, SyncTimeoutError

JOIN_S = 30.0
COUNTS = ("finished", "terminal", "cancelled", "expired", "failed",
          "tokens", "decode_dispatches", "p50_queued_steps",
          "p99_queued_steps", "p50_prefill_steps", "p99_prefill_steps",
          "p50_decode_steps", "p99_decode_steps", "queue_depth",
          "active_rows", "deadline_rows", "late_rows")


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompts(lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _engine(cls, model, params, extra, prompts, new_tokens, *,
            layout="paged", sharing="off", capacity=2, chunk=6, **kw):
    max_len = max(len(p) for p in prompts) + new_tokens + 1
    return cls(model, params, capacity=capacity, max_len=max_len,
               decode_chunk=2, kv_layout=layout, page_size=8,
               prefix_sharing=sharing, prefill_chunk_tokens=chunk, **kw,
               **extra)


def _engines(models, prompts, new_tokens, **kw):
    """(JAX engine, port engine) on the same settings."""
    jm, jp, tm, tp = models
    return (_engine(JEngine, jm, jp, {"seed": 0}, prompts, new_tokens, **kw),
            _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, prompts,
                    new_tokens, **kw))


def _drive(eng, prompts, new_tokens, *, arrivals=None, on_round=None,
           max_rounds=500):
    arr = (np.zeros(len(prompts)) if arrivals is None
           else np.asarray(arrivals))
    reqs, nxt, rounds = [], 0, 0
    while nxt < len(prompts) or eng.queue or eng.active \
            or eng._cancel_pending:
        while nxt < len(prompts) and arr[nxt] <= eng.step_clock:
            reqs.append(eng.submit(prompts[nxt], new_tokens))
            nxt += 1
        if eng.step() == 0 and not eng.queue and nxt < len(prompts):
            eng.step_clock += 1
        if on_round is not None:
            on_round(eng, reqs)
        rounds += 1
        assert rounds < max_rounds, "engine failed to drain"
    return reqs


def _record(eng, reqs):
    st = eng.stats()
    rec = {"streams": [list(r.out_tokens) for r in reqs],
           "states": [r.state.value for r in reqs],
           "steps": [(r.arrival_step, r.grant_step, r.decode_start_step,
                      r.finish_step) for r in reqs],
           "grant_log": list(eng.grant_log),
           **{k: st[k] for k in COUNTS}}
    if eng.kv_layout == "paged":
        rec["acquires"] = eng.pool.pages.lock_stats()["acquires"]
        eng.pool.pages.check()
        assert eng.pool.pages.n_free == eng.pool.pages.num_pages
    return rec


# ================================================================ cancel
CANCEL_CONFIGS = [("slots", "off"), ("paged", "off"), ("paged", "on")]


def _cancel_run(eng, prompts, new_tokens, target):
    """Serve ``prompts``; cancel request 0 as soon as it is in ``target``
    (QUEUED: before the first round). Returns (requests, cancelled)."""
    if target is RequestState.QUEUED:
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        assert eng.cancel(reqs[0].rid)
        rounds = 0
        while eng.queue or eng.active:
            eng.step()
            rounds += 1
            assert rounds < 200
        return reqs, True
    done = []

    def on_round(e, reqs):
        if target is None or done or not reqs:
            return
        if reqs[0].state.value == target.value:
            assert e.cancel(reqs[0].rid)
            done.append(True)
    return _drive(eng, prompts, new_tokens, on_round=on_round), bool(done)


@pytest.mark.parametrize("layout,sharing", CANCEL_CONFIGS)
def test_cancel_every_state_matches_reference(models, layout, sharing):
    """Request 0 (which prompt 2 repeats, so sharing shares) is cancelled
    in each state; both engines agree on everything, the survivors'
    streams equal a run with no cancellation, and nothing leaks."""
    _, _, tm, tp = models
    prompts = _prompts([14, 5, 9])
    prompts[2] = prompts[0].copy()
    new = 5
    base_eng = _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, prompts,
                       new, layout=layout, sharing=sharing)
    base = _record(base_eng, _cancel_run(base_eng, prompts, new, None)[0])
    assert all(len(s) == new for s in base["streams"])
    for state in (RequestState.QUEUED, RequestState.PREFILLING,
                  RequestState.DECODING):
        recs = []
        for eng in _engines(models, prompts, new, layout=layout,
                            sharing=sharing):
            reqs, cancelled = _cancel_run(eng, prompts, new, state)
            assert cancelled, state
            recs.append(_record(eng, reqs))
        assert recs[1] == recs[0], state
        got = recs[1]
        assert got["states"] == ["cancelled", "finished", "finished"]
        assert len(got["streams"][0]) < new
        assert got["streams"][1:] == base["streams"][1:]
        assert (got["cancelled"], got["terminal"], got["finished"]) == \
            (1.0, 3.0, 2.0)


def test_cancel_frees_pages_at_next_round_boundary(models):
    """A lone decoding request: one step after cancel every page is back,
    through at most one allocator acquire."""
    _, _, tm, tp = models
    prompts = _prompts([12])
    eng = _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, prompts, 8)
    req = eng.submit(prompts[0], 8)
    while req.state is not RequestState.DECODING:
        eng.step()
    assert eng.pool.pages.n_free < eng.pool.pages.num_pages
    assert eng.cancel(req.rid)
    assert req.state is RequestState.DECODING      # at the round boundary
    before = eng.pool.pages.lock_stats()["acquires"]
    eng.step()
    assert req.state is RequestState.CANCELLED
    assert eng.pool.pages.n_free == eng.pool.pages.num_pages
    assert eng.pool.pages.lock_stats()["acquires"] - before <= 1


def test_cancel_unknown_or_finished_is_refused(models):
    _, _, tm, tp = models
    prompts = _prompts([8])
    eng = _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, prompts, 4)
    assert not eng.cancel(12345)
    reqs = _drive(eng, prompts, 4)
    assert reqs[0].state is RequestState.FINISHED
    assert not eng.cancel(reqs[0].rid)
    assert eng.stats()["cancelled"] == 0


def test_cancelled_request_still_donates_written_prefix(models):
    """A request cancelled mid-prefill has written real K/V: its full
    pages are donated like a finished one's, a resubmission adopts them,
    and both engines agree on the cache's counts."""
    jm, jp, tm, tp = models
    prompt = np.random.default_rng(10).integers(1, 512, 16).astype(np.int32)
    outs = []
    for cls, m, p, extra in ((JEngine, jm, jp, {"seed": 0}),
                             (SlotServeEngine, tm, tp, {"device": "cpu"})):
        eng = cls(m, p, capacity=2, max_len=48, kv_layout="paged",
                  page_size=4, prefix_cache="on", prefill_chunk_tokens=4,
                  decode_chunk=2, **extra)
        victim = eng.submit(prompt, 6)
        eng.step()                              # one 4-token chunk lands
        assert eng.cancel(victim.rid)
        eng.run_until_done(max_rounds=50)
        donated = eng.prefix_cache.pages_held
        assert donated >= 1
        again = eng.submit(prompt.copy(), 4)
        eng.run_until_done(max_rounds=200)
        assert again.state.value == "finished"
        st = eng.stats()
        assert st["cache_hits"] >= 1.0 and st["prefill_tokens_saved"] > 0
        outs.append((donated, list(again.out_tokens), victim.state.value,
                     {k: v for k, v in st.items() if k.startswith("cache_")
                      or k in ("prefill_tokens_saved", "cancelled")}))
        eng.drop_prefix_cache()
        assert eng.pool.pages.in_use == 0
    assert outs[1] == outs[0]


# ============================================================= deadlines
def test_queued_past_deadline_expires_before_admission(models):
    prompts = _prompts([10, 10, 10])
    recs = []
    for eng in _engines(models, prompts, 8, capacity=1, chunk=None):
        blocker = eng.submit(prompts[0], 8)
        doomed = eng.submit(prompts[1], 8, deadline_step=eng.step_clock + 1)
        patient = eng.submit(prompts[2], 8)
        rounds = 0
        while eng.queue or eng.active:
            eng.step()
            rounds += 1
            assert rounds < 200
        assert doomed.state.value == "expired" and doomed.grant_step == -1
        assert doomed.rid not in eng.grant_log
        recs.append(_record(eng, [blocker, doomed, patient]))
    assert recs[1] == recs[0]
    assert recs[1]["states"] == ["finished", "expired", "finished"]
    assert (recs[1]["expired"], recs[1]["finished"]) == (1.0, 2.0)


def test_wall_clock_deadline_already_past_expires_in_queue(models):
    """A wall-clock deadline already past at submit (the one outcome that
    cannot depend on timing) expires the request in the queue."""
    _, _, tm, tp = models
    prompts = _prompts([6, 6])
    eng = _engine(SlotServeEngine, tm, tp, {"device": "cpu"}, prompts, 3)
    late = eng.submit(prompts[0], 3, deadline_s=time.perf_counter() - 1.0)
    ok = eng.submit(prompts[1], 3)
    eng.run_until_done()
    assert late.state is RequestState.EXPIRED and late.grant_step == -1
    assert ok.state is RequestState.FINISHED
    assert eng.grant_log == [ok.rid]


def test_late_eviction_expires_instead_of_requeueing(models):
    """A row past its deadline evicted under page pressure expires; its
    ``slot_deadlines`` before and after equal the JAX engine's."""
    prompts = _prompts([10])
    recs = []
    for eng in _engines(models, prompts, 8):
        req = eng.submit(prompts[0], 8, deadline_step=2)
        while req.state.value != "decoding":
            eng.step()
        before = eng.slot_deadlines()
        eng.step_clock = 10
        assert req.past_deadline(eng.step_clock)
        after = eng.slot_deadlines()
        eng._preempt(req.slot)
        assert req.state.value == "expired"
        assert req.rid not in [r.rid for r in eng.queue]
        recs.append((before, after, _record(eng, [req])))
    assert recs[1] == recs[0]
    assert recs[1][2]["expired"] == 1.0
    assert recs[1][1][0]["late"] and recs[1][1][0]["slack_steps"] == -8.0


def test_time_in_state_partitions_lifetime(models):
    prompts = _prompts([14, 6, 9, 12])
    recs = []
    for eng in _engines(models, prompts, 5):
        reqs = _drive(eng, prompts, 5, arrivals=[0, 0, 2, 5])
        for r in reqs:
            assert r.state.value == "finished"
            assert (r.queued_steps + r.prefill_steps + r.decode_steps
                    == r.finish_step - r.arrival_step), r.rid
            assert r.decode_steps > 0
        recs.append(_record(eng, reqs))
    assert recs[1] == recs[0]
    assert recs[1]["p99_prefill_steps"] > 0.0


# ======================================================= bounded waits
def _holder(prim, held: threading.Event, release_after_s: float):
    """A thread that takes ``prim``, signals, and releases after a delay."""
    def run():
        if hasattr(prim, "lock"):
            prim.lock()
        else:
            prim.wait()
        held.set()
        time.sleep(release_after_s)
        (prim.unlock if hasattr(prim, "unlock") else prim.post)()
    return threading.Thread(target=run, daemon=True)


def _release(prim):
    (prim.unlock if hasattr(prim, "unlock") else prim.post)()


def _bounded_outcomes(lib_cls, timeout_cls, make):
    """The outcomes of acquire / try_acquire against a free primitive and
    one held by a thread that releases: ok, timed out (the exception's
    type and fields), and the primitive usable afterwards."""
    out = []
    prim = make()
    lib_cls.acquire(prim, timeout=1.0, what="free")
    _release(prim)
    out.append("free-acquired")
    out.append(("try-free", lib_cls.try_acquire(prim)))
    _release(prim)
    for timeout, delay in ((5.0, 0.05), (0.01, 0.15)):
        held = threading.Event()
        t = _holder(prim, held, delay)
        t.start()
        assert held.wait(JOIN_S)
        try:
            lib_cls.acquire(prim, timeout=timeout, what="admission gate")
            out.append(("acquired", timeout))
            _release(prim)
        except timeout_cls as e:
            assert e.primitive is prim and e.timeout_s == timeout
            assert "admission gate" in str(e)
            out.append(("timed-out", timeout, type(prim).__name__))
        t.join(JOIN_S)
        assert not t.is_alive()
    held = threading.Event()
    t = _holder(prim, held, 0.05)
    t.start()
    assert held.wait(JOIN_S)
    out.append(("try-held", lib_cls.try_acquire(prim)))
    t.join(JOIN_S)
    assert not t.is_alive()
    lib_cls.acquire(prim, timeout=1.0)          # still consistent
    _release(prim)
    return out


PRIMS = {
    "ticket": lambda hs: hs.TicketMutex(),
    "futex": lambda hs: hs.FutexMutex(),
    "spin": lambda hs: hs.SpinMutex(),
    "sleeping_semaphore": lambda hs: hs.SleepingSemaphore(1),
    "spin_semaphore": lambda hs: hs.SpinSemaphore(1),
}


@pytest.mark.parametrize("kind", sorted(PRIMS))
def test_bounded_acquire_matches_reference(kind):
    """``acquire`` succeeds on a free primitive and on one released within
    its budget, raises ``SyncTimeoutError`` (the primitive not held, still
    usable) past it, and ``try_acquire`` is True only when free — the
    same outcomes as the reference's library on its own primitives."""
    want = _bounded_outcomes(JSyncLibrary, JSyncTimeoutError,
                             lambda: PRIMS[kind](jhs))
    got = _bounded_outcomes(SyncLibrary, SyncTimeoutError,
                            lambda: PRIMS[kind](ths))
    assert got == want
    assert got[1] == ("try-free", True) and got[-1] == ("try-held", False)
    assert got[2] == ("acquired", 5.0) and got[3][0] == "timed-out"


def test_acquire_without_a_bounded_form_raises_type_error():
    with pytest.raises(TypeError, match="no bounded acquire form"):
        SyncLibrary.acquire(object(), timeout=0.1)
    assert issubclass(SyncTimeoutError, TimeoutError)


def test_futex_mutex_excludes_under_stress():
    """More threads than cores incrementing one counter under the futex
    mutex, at a short switch interval: no update is lost, every acquire
    is counted."""
    m = ths.FutexMutex(spin_tries=4)
    box = [0]
    n_threads, n_iters = 12, 150

    def work():
        for _ in range(n_iters):
            with m:
                v = box[0]
                time.sleep(0)
                box[0] = v + 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert box[0] == n_threads * n_iters
    st = m.lock_stats()
    assert st["acquires"] == n_threads * n_iters
    assert 0 <= st["contended_acquires"] <= st["acquires"]


@pytest.mark.parametrize("kind", ["auto", "spin", "fa", "ticket", "futex"])
def test_make_mutex_matches_reference(kind):
    assert type(ths.make_mutex(kind)).__name__ == \
        type(jhs.make_mutex(kind)).__name__


@pytest.mark.parametrize("kind", ["auto", "spin", "sleeping"])
def test_make_semaphore_matches_reference(kind):
    t, j = ths.make_semaphore(3, kind), jhs.make_semaphore(3, kind)
    assert type(t).__name__ == type(j).__name__
    assert t.wait(timeout=1.0) and j.wait(timeout=1.0)
    t.post()
    j.post()


def test_library_builds_the_futex_mutex():
    """The host backend's ``"futex"`` mutex, as the reference's."""
    m = SyncLibrary.host_default().mutex(kind="futex")
    assert type(m) is ths.FutexMutex
    assert type(JSyncLibrary.host_default().mutex(kind="futex")).__name__ \
        == "FutexMutex"
    assert m.lock(timeout=1.0)
    m.unlock()
    assert m.lock_stats()["acquires"] == 1
