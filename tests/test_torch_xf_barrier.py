"""XF flag barrier: the port's plain version and windowed planner
against the JAX package's Pallas kernel (interpret mode) and its
pure-jnp oracle on the cases of tests/test_kernels.py — every output
exact — plus stale flags, random membership and windowed padding.

The CUDA kernel runs only on a card (``test_cuda_*`` skip without one;
``chip_smoke.py`` phase 2 checks it exact on the card every run). Its
schedule is modelled on the CPU in tests/test_torch_xf_barrier_model.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xf_barrier import ops as jops
from repro.kernels.xf_barrier.ref import xf_barrier_ref
from repro_torch.kernels import xf_barrier as txb


def _both(arrive, epoch, present, required):
    """(port outputs, Pallas outputs, oracle outputs) as numpy."""
    j = [jnp.asarray(x, jnp.int32) for x in (arrive, present, required)]
    want = jops.xf_barrier(j[0], jnp.int32(epoch), j[1], j[2],
                           interpret=True)
    want_ref = xf_barrier_ref(j[0], jnp.int32(epoch), j[1], j[2])
    t = [torch.as_tensor(np.asarray(x, np.int32))
         for x in (arrive, present, required)]
    got = txb.xf_barrier(t[0], epoch, t[1], t[2])
    return ([g.numpy() for g in got], [np.asarray(w) for w in want],
            [np.asarray(w) for w in want_ref])


def _assert_same(arrive, epoch, present, required):
    got, want, want_ref = _both(arrive, epoch, present, required)
    for g, w, r in zip(got, want, want_ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert all(g.dtype == np.int32 for g in got)
    return got


@pytest.mark.parametrize("n", [3, 8, 64, 130, 200])
def test_all_present(n):
    ones = np.ones(n, np.int32)
    got = _assert_same(np.zeros(n, np.int32), 1, ones, ones)
    assert int(got[2]) == 1


@pytest.mark.parametrize("n,absent", [(8, [2]), (64, [0, 63]), (16, [5, 6])])
def test_stragglers(n, absent):
    present = np.ones(n, np.int32)
    present[absent] = 0
    arrive, release, done, strag = _assert_same(
        np.zeros(n, np.int32), 3, present, np.ones(n, np.int32))
    assert int(done) == 0
    assert sorted(np.flatnonzero(strag).tolist()) == sorted(absent)
    assert np.all(release == 0)


def test_epoch_reuse():
    n = 10
    ones = torch.ones(n, dtype=torch.int32)
    flags = txb.fresh_flags(n, device="cpu")
    for epoch in (1, 2, 3):
        flags, release, done, _ = txb.xf_barrier(flags, epoch, ones, ones)
        assert int(done) == 1
        assert np.all(release.numpy() == epoch)


@pytest.mark.parametrize("seed", range(6))
def test_random_membership_over_stale_flags(seed):
    """Random present/required masks over flags left by earlier epochs
    (some ahead of this epoch): a required slot that is absent but
    already ahead counts as arrived, as in the reference."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    arrive = rng.integers(0, 5, n).astype(np.int32)
    present = (rng.uniform(size=n) < 0.8).astype(np.int32)
    required = (rng.uniform(size=n) < 0.7).astype(np.int32)
    _assert_same(arrive, int(rng.integers(1, 5)), present, required)


@pytest.mark.parametrize("n,window", [(0, 32), (5, 32), (33, 32), (70, 16)])
def test_window_matches_reference_window(n, window):
    rng = np.random.default_rng(n + window)
    arrive = rng.integers(0, 3, n).astype(np.int32)
    present = (rng.uniform(size=n) < 0.85).astype(np.int32)
    required = (rng.uniform(size=n) < 0.9).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jops.xf_barrier_window(arrive, 2, present, required,
                                      window=window, use_kernel=False)
        got = txb.xf_barrier_window(arrive, 2, present, required,
                                    window=window, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (n,) and got[3].shape == (n,)


def test_pad_slots_are_neither_present_nor_required():
    arrays = tuple(np.ones(3, np.int32) for _ in range(3))
    padded = txb._pad_barrier(arrays, 3, 8)
    for p, j in zip(padded, jops._pad_barrier(arrays, 3, 8)):
        np.testing.assert_array_equal(p, j)
    assert not padded[1][3:].any() and not padded[2][3:].any()


def test_wrapper_checks_shapes_and_devices():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"expected \(N,\)"):
        txb.xf_barrier(z, 1, z[:3], z)
    with pytest.raises(ValueError, match="max_polls"):
        txb.xf_barrier(z, 1, z, z, max_polls=-1)
    m = z.to("meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        txb.xf_barrier(m, 1, m, m)


def test_size_limit_names_the_limit():
    """``SHARED_N`` names where the kernel's flags leave shared memory;
    past it nothing is refused: the window at N SHARED_N + 1 plans like
    the reference's oracle (a straggler, so done is 0)."""
    n = txb.SHARED_N + 1
    present = np.ones(n, np.int32)
    present[n - 2] = 0
    ones = np.ones(n, np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = txb.xf_barrier_window(np.zeros(n, np.int32), 1, present,
                                    ones, window=n, device="cpu")
    want = xf_barrier_ref(jnp.zeros(n, jnp.int32), jnp.int32(1),
                          jnp.asarray(present), jnp.asarray(ones))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[2]) == 0 and np.flatnonzero(got[3]).tolist() == [n - 2]


@pytest.mark.parametrize("max_polls", [0, 1])
def test_window_budget_does_not_change_the_result(max_polls):
    rng = np.random.default_rng(max_polls)
    n = 20
    arrive = rng.integers(0, 3, n).astype(np.int32)
    present = (rng.uniform(size=n) < 0.85).astype(np.int32)
    required = np.ones(n, np.int32)
    got = txb.xf_barrier_window(arrive, 2, present, required,
                                max_polls=max_polls, device="cpu")
    want = jops.xf_barrier_window(arrive, 2, present, required,
                                  max_polls=max_polls, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txb.xf_barrier_window([0, 0], 1, [1, 1], [1, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txb.fresh_flags(4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 64, 1024])
@pytest.mark.parametrize("case", ["all", "stragglers", "rank0_absent"])
def test_cuda_kernel_equal_to_plain(cuda_device, n, case):
    present = np.ones(n, np.int32)
    if case == "stragglers":
        present[n // 2] = 0
    elif case == "rank0_absent":
        present[0] = 0
    ts = [torch.from_numpy(x) for x in (np.zeros(n, np.int32), present,
                                        np.ones(n, np.int32))]
    before = txb.XF_BARRIER.launches
    got = txb.xf_barrier(ts[0].to(cuda_device), 1, ts[1].to(cuda_device),
                         ts[2].to(cuda_device))
    want = txb.xf_barrier_plain(ts[0], 1, ts[1], ts[2])
    assert txb.XF_BARRIER.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("max_polls", [0, 1])
def test_cuda_budget_does_not_change_the_result(cuda_device, n, max_polls):
    """Everyone present with a budget of 0 or 1: a master that scanned
    before a present participant had stored its flag would report done
    = 0 where the reference reports 1."""
    ones = torch.ones(n, dtype=torch.int32)
    want = txb.xf_barrier_plain(torch.zeros_like(ones), 1, ones, ones)
    a, o = torch.zeros_like(ones).to(cuda_device), ones.to(cuda_device)
    for _ in range(50):
        got = txb.xf_barrier(a, 1, o, o, max_polls=max_polls)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("n", [4096, txb.SHARED_N, txb.SHARED_N + 1,
                               2 * txb.SHARED_N])
@pytest.mark.parametrize("max_polls", [0, 1024])
def test_cuda_large_barriers_equal_to_plain(cuda_device, n, max_polls):
    rng = np.random.default_rng(n + max_polls)
    for present, required in (
            (np.ones(n, np.int32), np.ones(n, np.int32)),
            ((rng.uniform(size=n) < 0.9).astype(np.int32),
             (rng.uniform(size=n) < 0.8).astype(np.int32))):
        arrive = rng.integers(0, 4, n).astype(np.int32)
        ts = [torch.from_numpy(x) for x in (arrive, present, required)]
        a, p, r = (t.to(cuda_device) for t in ts)
        got = txb.xf_barrier(a, 3, p, r, max_polls=max_polls)
        want = txb.xf_barrier_plain(ts[0], 3, ts[1], ts[2])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("max_polls", [0, 1, 1024])
def test_cuda_plans_past_shared_memory(cuda_device, max_polls):
    """N 32769 and 65536 (flags in global memory): the tensor call and the
    window plan equal the plain version, everyone present or not."""
    for n in (txb.SHARED_N + 1, 2 * txb.SHARED_N):
        present = np.ones(n, np.int32)
        for absent in ([], [0, n - 1]):
            present[absent] = 0
            ones = np.ones(n, np.int32)
            ts = [torch.from_numpy(x) for x in (np.zeros(n, np.int32),
                                                present, ones)]
            got = txb.xf_barrier(*(t.to(cuda_device) for t in ts[:1]), 1,
                                 ts[1].to(cuda_device), ts[2].to(cuda_device),
                                 max_polls=max_polls)
            want = txb.xf_barrier_plain(ts[0], 1, ts[1], ts[2])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got_w = txb.xf_barrier_window(
                    ts[0].numpy(), 1, present, ones, max_polls=max_polls,
                    window=n, device=cuda_device)
            for g, w in zip(got_w, want):
                np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("n,window", [(5, 32), (12, 32), (33, 32)])
def test_cuda_window_equal_to_cpu(cuda_device, n, window):
    """One launch per window plan, and the plan equal to the CPU's."""
    rng = np.random.default_rng(n)
    for max_polls in (0, 1, 1024):
        arrive = rng.integers(0, 3, n).astype(np.int32)
        present = (rng.uniform(size=n) < 0.85).astype(np.int32)
        required = (rng.uniform(size=n) < 0.9).astype(np.int32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            before = txb.XF_BARRIER.launches
            got = txb.xf_barrier_window(arrive, 2, present, required,
                                        max_polls=max_polls, window=window,
                                        device=cuda_device)
            assert txb.XF_BARRIER.launches == before + 1
            want = txb.xf_barrier_window(arrive, 2, present, required,
                                         max_polls=max_polls, window=window,
                                         device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
