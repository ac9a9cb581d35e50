"""The host control plane of the port against the JAX package's: the
Algorithm-3 ticket mutex, the page allocator under it, the admission
gate, the machine abstraction's selections and the round planner —
identical grant orders, grant logs, refcounts and lock counters on the
same seeded traces."""

import threading

import numpy as np
import pytest
import torch

from repro.core import abstraction as jabs
from repro.core import hostsync as jhs
from repro.serve import dispatch as jdispatch
from repro.serve import kv_pages as jkv
from repro.serve import scheduler as jsched
from repro_torch.core import abstraction as tabs
from repro_torch.core import hostsync as ths
from repro_torch.serve import dispatch as tdispatch
from repro_torch.serve import kv_pages as tkv
from repro_torch.serve import scheduler as tsched
from repro_torch.sync import SyncLibrary


# ------------------------------------------------------------ ticket mutex
def _fifo_run(mutex_cls, n=6):
    """n requesters take tickets in a fixed order while the first holder
    stalls in its critical section; returns (grant order, lock stats)."""
    mtx = mutex_cls()
    order = []
    everyone = threading.Event()

    def worker(j):
        mtx.lock()
        if not order:
            everyone.wait(timeout=20.0)
        order.append(j)
        mtx.unlock()

    threads = []
    for j in range(n):
        t = threading.Thread(target=worker, args=(j,))
        t.start()
        threads.append(t)
        for _ in range(200000):              # ticket issued before next
            if mtx._ticket.load() == j + 1:
                break
    everyone.set()
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive()
    return order, mtx.lock_stats()


def test_ticket_mutex_fifo_and_stats_match_reference():
    j_order, j_stats = _fifo_run(jhs.TicketMutex)
    t_order, t_stats = _fifo_run(ths.TicketMutex)
    assert t_order == j_order == list(range(6))
    for key in ("acquires", "contended_acquires", "watchdog_trips"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["contended_acquires"] == 5


def test_adaptive_mutex_retunes_like_reference():
    for c in (0.0, 0.05, 0.3, 0.9):
        j = jhs.AdaptiveMutex(jhs.TicketMutex(), jabs.FERMI)
        t = ths.AdaptiveMutex(ths.TicketMutex(), tabs.FERMI)
        assert t.retune(c).value == j.retune(c).value
        assert t.retunes == j.retunes


def _blocked_until_post(sem):
    """A third wait() at capacity 2 blocks until a post() hands it the
    slot (bounded joins: the reference's timed-out waiter still waits
    for its turn, so the test never relies on a timeout)."""
    got = threading.Event()
    t = threading.Thread(target=lambda: (sem.wait(), got.set()))
    t.start()
    assert not got.wait(timeout=0.05)
    sem.post()
    t.join(timeout=10.0)
    assert not t.is_alive() and got.is_set()


@pytest.mark.parametrize("cls", ["SleepingSemaphore", "SpinSemaphore"])
def test_semaphores_gate_capacity(cls):
    for mod in (jhs, ths):
        sem = getattr(mod, cls)(2)
        assert sem.wait() and sem.wait()
        _blocked_until_post(sem)


def test_admission_controller_matches_reference():
    j = jsched.AdmissionController(2)
    t = tsched.AdmissionController(2, lib=SyncLibrary.host_default())
    for ctl in (j, t):
        assert ctl.acquire_slot() and ctl.acquire_slot()
        ctl.release_slot()
        assert ctl.acquire_slot()
        ctl.release_slot()
    assert (t.admitted, t.completed, t.in_flight, t.kind) == (
        j.admitted, j.completed, j.in_flight, j.kind)


# ------------------------------------------------------------- page pool
def _state(pool):
    return (list(pool._free), pool._refcount.tolist(), list(pool.grant_log),
            pool.allocs, pool.frees, pool.pages_alloced, pool.pages_freed,
            pool.lock_stats()["acquires"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_churn_matches_reference(seed):
    """Seeded alloc_batch/free_batch churn (all-or-nothing and partial
    grants, exhaustion, multi-group frees) through both pools in
    lockstep: same grants, grant log, refcounts, free-list order and
    acquire counts after every call."""
    rng = np.random.default_rng(seed)
    jp = jkv.PagePool(24, 4)
    tp = tkv.PagePool(24, 4)
    held = []
    for step in range(250):
        if not held or rng.random() < 0.55:
            counts = rng.integers(0, 5, size=int(rng.integers(1, 4)))
            tags = [f"r{step}.{i}" for i in range(len(counts))]
            partial = bool(rng.random() < 0.5)
            outs = []
            for pool, exc in ((jp, jkv.PagePoolExhausted),
                              (tp, tkv.PagePoolExhausted)):
                try:
                    outs.append(pool.alloc_batch(counts, tags,
                                                 partial=partial))
                except exc:
                    outs.append("exhausted")
            jo, to = outs
            if to == "exhausted":
                assert jo == "exhausted"
            else:
                assert len(jo) == len(to)
                for a, b in zip(jo, to):
                    assert (a is None and b is None) or np.array_equal(a, b)
                held.extend(g for g in to if g is not None and g.size)
        else:
            k = int(rng.integers(1, min(3, len(held)) + 1))
            pick = sorted(rng.choice(len(held), size=k, replace=False),
                          reverse=True)
            groups = [held.pop(int(i)) for i in pick]
            assert jp.free_batch(groups) == tp.free_batch(groups)
        assert _state(tp) == _state(jp)
        tp.check()


def test_page_pool_refuses_double_free_atomically():
    for pool, exc in ((jkv.PagePool(8, 4), jkv.PageLeakError),
                      (tkv.PagePool(8, 4), tkv.PageLeakError)):
        a, b = pool.alloc_batch([2, 2])
        pool.free_batch([a])
        before = _state(pool)
        with pytest.raises(exc):
            pool.free_batch([b, a])          # a is already free
        assert _state(pool)[:7] == before[:7]
        pool.check()


def test_page_pool_rolls_back_a_faulted_batch_like_reference():
    """An exception inside the critical section (the second grant of a
    batch) rolls every grant back through the undo journal: state and
    free-list order as before, and the next batch grants exactly what a
    never-faulted pool grants — in both packages."""
    results = []
    for mod in (jkv, tkv):
        pool = mod.PagePool(10, 4)
        first = pool.alloc_batch([3], ["a"])
        before = _state(pool)[:7]
        grants = []

        def hook(stage):
            if stage == "alloc:grant":
                grants.append(stage)
                if len(grants) == 2:
                    raise RuntimeError("injected")

        pool.fault_hook = hook
        with pytest.raises(RuntimeError, match="injected"):
            pool.alloc_batch([2, 2], ["b", "c"])
        pool.fault_hook = None
        assert _state(pool)[:7] == before
        assert pool.aborted_batches == 1
        results.append((first, pool.alloc_batch([2, 2], ["b", "c"]),
                        list(pool.grant_log)))
    (j_first, j_next, j_log), (t_first, t_next, t_log) = results
    assert np.array_equal(j_first[0], t_first[0]) and j_log == t_log
    assert all(np.array_equal(a, b) for a, b in zip(j_next, t_next))


def test_page_pool_incref_keeps_a_page_until_the_last_reference():
    pool = tkv.PagePool(4, 2)
    (a,) = pool.alloc_batch([1])
    pool.incref_batch([a])
    assert pool.free_batch([a]) == []
    assert pool.free_batch([a]) == [int(a[0])]
    with pytest.raises(tkv.PageLeakError):
        pool.incref_batch([a])
    pool.check()


# ------------------------------------------------- abstraction + planning
MACHINES = [(jabs.TESLA, tabs.TESLA), (jabs.FERMI, tabs.FERMI),
            (jabs.TPU_V5E, tabs.TPU_V5E)]


@pytest.mark.parametrize("jm,tm", MACHINES)
def test_selection_matches_reference(jm, tm):
    assert tabs.classify(tm) == jabs.classify(jm)
    assert tm.summary() == jm.summary()
    for kind in ("MUTEX", "SEMAPHORE", "BARRIER"):
        for c in (0.0, 0.3, 1.0):
            for init in (1, 8):
                j = jabs.select_impl(jm, jabs.PrimitiveKind[kind],
                                     semaphore_initial=init,
                                     expected_contention=c)
                t = tabs.select_impl(tm, tabs.PrimitiveKind[kind],
                                     semaphore_initial=init,
                                     expected_contention=c)
                assert (t.algorithm, t.strategy.value, t.rationale) == (
                    j.algorithm, j.strategy.value, j.rationale)
    for c in np.linspace(0, 1, 11):
        assert (tabs.select_wait_strategy(tm, c).value
                == jabs.select_wait_strategy(jm, c).value)


def test_planning_backend_follows_the_device(monkeypatch):
    lib = SyncLibrary.host_default()
    assert lib.backend_name() == "host"
    assert lib.planning_backend_name("cpu") == "ref"
    assert SyncLibrary.host_default(backend="ref").planning_backend_name(
        "cuda") == "ref"
    # the host backend (the library's default) plans as the reference's
    # does: mutex and barrier plans and the observed semaphore timeline
    plan = lib.plan_mutex([1, 0])
    assert plan.backend == "host" and plan.fifo
    assert plan.turn_trace.tolist() == [0, 1]
    sp = lib.plan_semaphore([0.0], [1.0], 1, backend="host")
    assert sp.backend == "host" and sp.grant.tolist() == [0.0]
    assert lib.plan_barrier([1, 1]).done == 1
    # naming cuda needs a card; with one, hot-loop plans go to the kernel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert lib.planning_backend_name("cuda") == "cuda"
    assert lib.planning_backend_name() == "cuda"


def test_planning_without_a_device_needs_the_card():
    """No device named means ``cuda``: without a card the planners raise
    rather than carry on with the plain version on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    lib = SyncLibrary.host_default()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lib.planning_backend_name()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lib.semaphore_planner(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.plan_admission(np.zeros(2, np.float32),
                              np.ones(2, np.float32), 1, lib=lib)
    assert tsched.plan_admission(np.zeros(2, np.float32),
                                 np.ones(2, np.float32), 1, lib=lib,
                                 device="cpu").backend == "ref"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.PagedSlotPool(None, 2, 8)


@pytest.mark.parametrize("seed", range(4))
def test_plan_round_and_contention_match_reference(seed):
    rng = np.random.default_rng(seed)
    decode = list(rng.choice(8, size=int(rng.integers(0, 4)),
                             replace=False))
    backlog = [s for s in range(8) if s not in decode][:int(
        rng.integers(0, 5))]
    remaining = {s: int(rng.integers(1, 20)) for s in backlog}
    kw = dict(chunk_tokens=int(rng.integers(1, 9)),
              decode_chunk=int(rng.integers(1, 3)), remaining=remaining)
    budget = int(rng.integers(0, 40))
    j = jsched.plan_round(budget, decode, backlog, **kw)
    t = tsched.plan_round(budget, decode, backlog, **kw)
    assert (t.decode_tokens, t.chunk_rows, t.deferred) == (
        j.decode_tokens, j.chunk_rows, j.deferred)
    cap, svc = int(rng.integers(1, 9)), float(rng.integers(1, 300))
    assert tsched.allocator_contention(cap, svc) == \
        jsched.allocator_contention(cap, svc)


@pytest.mark.parametrize("capacity", [1, 3, 5, 8])
def test_dispatch_buckets_match_reference(capacity):
    j = jdispatch.DecodeDispatchCache(capacity)
    t = tdispatch.DecodeDispatchCache(capacity)
    for n in range(1, capacity + 1):
        assert t.bucket(n) == j.bucket(n)
        rows = list(range(n))
        assert np.array_equal(t.pad_rows(rows, t.bucket(n)),
                              j.pad_rows(rows, j.bucket(n)))
