"""The sync library's plan forms in the port against the JAX package's:
``plan_mutex``, ``plan_mutex_bounded`` and ``plan_barrier`` on the
port's ``host`` (observed execution on real threads) and ``ref`` (the
plain versions) backends against the JAX library's ``ref`` and
``kernel`` (Pallas interpret) backends; the host ``plan_semaphore``
against JAX ``ref``; the live barriers; and the two benchmark twins on
the CPU. Inputs come from numpy seeds; every test is parametrised over
seeds rather than drawn by hypothesis.

Every host-thread run is bounded: the host plans time their own waits
out (20 s, 0.5 s for a barrier epoch), and the live-barrier threads are
joined with a timeout.
"""

import json
import threading

import numpy as np
import pytest
import torch

from repro.core import hostsync as jhs
from repro.kernels.ticket_lock.ops import ticket_lock_bounded_oracle
from repro.sync import SyncLibrary as JSyncLibrary
from repro.sync import backends as jbackends
from repro_torch.benchmarks import kernelbench, primitives
from repro_torch.core import abstraction as tabs
from repro_torch.core import hostsync as ths
from repro_torch.sync import (BarrierPlan, BoundedMutexPlan, MutexPlan,
                              SyncLibrary)
from repro_torch.sync import backends as tbackends

PORT = ("host", "ref")
JAX = ("ref", "kernel")


@pytest.fixture(scope="module")
def libs():
    return SyncLibrary.host_default(), JSyncLibrary.host_default()


@pytest.mark.parametrize("seed", range(4))
def test_mutex_plans_match_reference(libs, seed):
    lib, jlib = libs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 11))
    arrival = rng.permutation(n).astype(np.int32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    want = {be: jlib.plan_mutex(arrival, m, b, backend=be) for be in JAX}
    for be in PORT:
        plan = lib.plan_mutex(arrival, m, b, backend=be)
        assert isinstance(plan, MutexPlan) and plan.backend == be
        assert plan.fifo
        for w in want.values():
            np.testing.assert_array_equal(plan.grant_order, w.grant_order)
            np.testing.assert_array_equal(plan.turn_trace, w.turn_trace)
            np.testing.assert_allclose(plan.acc, w.acc, rtol=2e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_barrier_plans_match_reference(libs, seed):
    lib, jlib = libs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 13))
    present = (rng.uniform(size=n) < 0.8).astype(np.int64)
    required = (rng.uniform(size=n) < 0.8).astype(np.int64)
    expect_done = int(np.all(present[required > 0]))
    want = {be: jlib.plan_barrier(present, required, epoch=1, backend=be)
            for be in JAX}
    for be in PORT:
        plan = lib.plan_barrier(present, required, epoch=1, backend=be)
        assert isinstance(plan, BarrierPlan) and plan.backend == be
        assert plan.done == expect_done
        for w in want.values():
            assert plan.done == w.done
            np.testing.assert_array_equal(plan.stragglers, w.stragglers)
            np.testing.assert_array_equal(plan.released, w.released)
            np.testing.assert_array_equal(plan.straggler_ranks,
                                          w.straggler_ranks)
        np.testing.assert_array_equal(
            plan.straggler_ranks,
            np.flatnonzero((required > 0) & (present == 0)))


@pytest.mark.parametrize("case", ["rank0_absent", "rank0_absent_required",
                                  "stale_flags"])
def test_barrier_plans_when_the_master_is_absent(libs, case):
    """Rank 0 is the host barrier's master; absent, the planning thread
    plays master, as the reference's does."""
    lib, jlib = libs
    n = 6
    present = np.ones(n, np.int64)
    present[0] = 0
    required = np.ones(n, np.int64)
    flags = None
    if case == "rank0_absent":
        required[0] = 0
    elif case == "stale_flags":       # rank 0's flag is already ahead
        flags = np.array([2, 0, 0, 0, 0, 0], np.int64)
    want = jlib.plan_barrier(present, required, epoch=2, flags=flags,
                             backend="ref")
    for be in PORT:
        plan = lib.plan_barrier(present, required, epoch=2, flags=flags,
                                backend=be)
        assert plan.done == want.done
        np.testing.assert_array_equal(plan.released, want.released)
        np.testing.assert_array_equal(plan.stragglers, want.stragglers)
        np.testing.assert_array_equal(plan.arrive, want.arrive)


@pytest.mark.parametrize("seed", range(4))
def test_bounded_mutex_plans_match_oracle_and_reference(libs, seed):
    lib, jlib = libs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 11))
    arrivals = np.sort(rng.uniform(0, 2, n)).astype(np.float32)
    holds = rng.uniform(0.5, 1.5, n).astype(np.float32)
    timeouts = rng.choice([0.0, 0.7, 2.5, np.inf], size=n).astype(
        np.float32)
    g_ref, grant_ref, rel_ref = ticket_lock_bounded_oracle(
        arrivals, holds, timeouts)
    want = {be: jlib.plan_mutex_bounded(arrivals, holds, timeouts,
                                        backend=be) for be in JAX}
    for be in PORT:
        plan = lib.plan_mutex_bounded(arrivals, holds, timeouts, backend=be)
        assert isinstance(plan, BoundedMutexPlan)
        np.testing.assert_array_equal(plan.granted, g_ref)
        np.testing.assert_allclose(plan.grant, grant_ref, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(plan.release, rel_ref, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(plan.timed_out,
                                      np.flatnonzero(~g_ref))
        assert 1 <= plan.iterations <= n + 2
        for w in want.values():
            np.testing.assert_array_equal(plan.granted, w.granted)
            assert plan.iterations == w.iterations
    free = lib.plan_mutex_bounded(arrivals, holds,
                                  np.full(n, np.inf, np.float32),
                                  backend="ref")
    assert free.granted.all()


def test_bounded_mutex_rejects_misaligned_traces(libs):
    with pytest.raises(ValueError, match="align"):
        libs[0].plan_mutex_bounded([0.0, 1.0], [1.0], [1.0, 1.0],
                                   backend="ref")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cap", [1, 3])
def test_host_semaphore_plan_matches_reference(libs, seed, cap):
    lib, jlib = libs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 13))
    arrivals = rng.uniform(0, 3, n).astype(np.float32)   # unsorted
    holds = rng.uniform(1, 3, n).astype(np.float32)
    want = jlib.plan_semaphore(arrivals, holds, cap, backend="ref")
    plan = lib.plan_semaphore(arrivals, holds, cap, backend="host")
    assert plan.backend == "host" and plan.order is not None
    np.testing.assert_array_equal(plan.waited, want.waited)
    np.testing.assert_array_equal(plan.grant_order, want.grant_order)
    np.testing.assert_allclose(plan.grant, want.grant, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plan.release, want.release, rtol=1e-5,
                               atol=1e-5)
    ref = lib.plan_semaphore(arrivals, holds, cap, backend="ref")
    assert ref.order is None
    np.testing.assert_array_equal(ref.grant_order, plan.grant_order)


def test_empty_traces_plan_on_every_port_backend(libs):
    lib = libs[0]
    for be in PORT:
        assert lib.plan_mutex([], backend=be).grant_order.size == 0
        assert lib.plan_barrier([], backend=be).done == 1
        assert lib.plan_semaphore([], [], 2, backend=be).grant.size == 0


# ----------------------------------------------------------- live barriers
def _run_barrier(bar, parties, epochs=3):
    results = {r: [] for r in range(parties)}

    def worker(rank):
        for _ in range(epochs):
            results[rank].append(bar.arrive_and_wait(rank, timeout=10.0))

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(parties)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive()
    return results


@pytest.mark.parametrize("kind", ["xf", "centralized"])
def test_live_barriers_complete_every_epoch_like_reference(kind):
    for mod in (jhs, ths):
        res = _run_barrier(mod.make_barrier(4, kind), 4)
        assert all(r == [True] * 3 for r in res.values())


def test_xf_barrier_reports_stragglers_like_reference():
    got = []
    for mod in (jhs, ths):
        bar = mod.XFBarrier(4, required=[True, True, False, True])
        bar._arrive = [1, 0, 0, 1]
        bar._epochs = [1, 0, 0, 1]
        got.append((bar.waiting_on(), bar.arrive_and_wait(0, timeout=0.01),
                    bar.waiting_on(2)))
    assert got[0] == got[1] == ([1], False, [1, 3])
    with pytest.raises(ValueError, match="one entry per party"):
        ths.XFBarrier(3, required=[True])


def test_library_barrier_follows_the_selection(libs):
    lib, jlib = libs
    assert type(lib.barrier(3)).__name__ == type(jlib.barrier(3)).__name__
    pinned = SyncLibrary.host_default(barrier_kind="centralized")
    assert isinstance(pinned.barrier(3), ths.CentralizedBarrier)
    assert isinstance(lib.barrier(3, kind="atomic"), ths.CentralizedBarrier)
    assert sorted(tbackends.HOST_BARRIERS) == sorted(jbackends.HOST_BARRIERS)


# ------------------------------------------------- devices and no fallback
def test_gpu_machines_plan_on_the_card():
    gpu = SyncLibrary(machine=tabs.FERMI)
    assert gpu.backend_name() == "cuda"
    assert gpu.planning_backend_name() == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda backend can plan")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu.plan_mutex([1, 0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu.plan_barrier([1, 1])


# ------------------------------------------------------ benchmark twins
def test_kernelbench_twin_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "kernels.json"
    recs = kernelbench.main(["--device", "cpu", "--out", str(out)])
    families = {r["family"] for r in recs}
    assert families == {"xf_barrier", "ticket_lock", "semaphore",
                        "membench", "paged_attention"}
    assert len(recs) == 9
    assert all(r["match"] and r["ms"] is None and r["device"] == "cpu"
               for r in recs)
    assert json.loads(out.read_text()) == recs
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["name"] for ln in lines] == [r["name"]
                                                        for r in recs]


def test_primitives_twin_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "primitives.json"
    blob = primitives.cli(["--smoke", "--device", "cpu", "--out",
                           str(out)])
    assert blob["device"] == "cpu"
    assert set(blob["backends_plan_latency_us"]) == {"semaphore", "mutex",
                                                     "barrier"}
    for lat in blob["backends_plan_latency_us"].values():
        assert set(lat) == {"host", "ref"}
    assert blob["table5"].startswith("match=8/8")
    assert json.loads(out.read_text()) == blob
    assert "sync_mutex_host" in capsys.readouterr().out


def test_benchmark_twins_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernelbench.records()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        primitives.smoke()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_cuda_plans_match_ref(cuda_device):
    gpu = SyncLibrary(machine=tabs.FERMI)
    rng = np.random.default_rng(0)
    arrival = rng.permutation(12).astype(np.int32)
    m = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    got = gpu.plan_mutex(arrival, m, b)
    want = gpu.plan_mutex(arrival, m, b, backend="ref")
    assert got.backend == "cuda"
    np.testing.assert_array_equal(got.grant_order, want.grant_order)
    assert np.float32(got.acc) == np.float32(want.acc)
    present = np.ones(12, np.int64)
    present[5] = 0
    bg = gpu.plan_barrier(present)
    br = gpu.plan_barrier(present, backend="ref")
    assert bg.done == br.done == 0
    np.testing.assert_array_equal(bg.stragglers, br.stragglers)
    assert all(r["match"] for r in kernelbench.records(cuda_device))
