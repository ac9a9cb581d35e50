"""Algorithm-5 admission timeline: the port's plain version and its
fixed-window planner against the JAX package's Pallas kernel (interpret
mode) and windowed op — bit-equal on grant, release and waited,
including windows that overflow into the next power of 2.

The CUDA kernel runs only on a card (``test_cuda_*`` skip without one;
``chip_smoke.py`` phase 2 checks it bit-equal on the card every run).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.semaphore.ops import (semaphore_admission,
                                         semaphore_admission_window)
from repro.kernels.semaphore.ref import sleeping_semaphore_ref
from repro_torch.kernels import semaphore as tsem
from repro_torch.sync import SyncLibrary


def _trace(seed, n, ties=False):
    rng = np.random.default_rng(seed)
    if ties:   # the engine's shape: in-flight holds all arrive "now"
        arr = np.concatenate([np.zeros(n // 2), 1e-3 * (np.arange(
            n - n // 2) + 1)]).astype(np.float32)
        hold = rng.integers(1, 9, n).astype(np.float32)
    else:
        arr = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
        hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
    return arr, hold


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    else:
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [8, 64, 100])
@pytest.mark.parametrize("capacity", [1, 3, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_bit_equal_to_pallas(n, capacity, ties):
    arr, hold = _trace(n * 7 + capacity, n, ties)
    want = semaphore_admission(jnp.asarray(arr), jnp.asarray(hold),
                               capacity=capacity, interpret=True)
    want_ref = sleeping_semaphore_ref(jnp.asarray(arr), jnp.asarray(hold),
                                      capacity)
    got = tsem.semaphore_admission(torch.from_numpy(arr),
                                   torch.from_numpy(hold), capacity)
    for w, wr, g in zip(want, want_ref, got):
        _bits_equal(w, g.numpy())
        _bits_equal(wr, g.numpy())


@pytest.mark.parametrize("n,window", [(5, 32), (32, 32), (40, 32),
                                      (70, 32), (64, 64), (130, 64)])
def test_window_bit_equal_to_reference_window(n, window):
    """Padding with far-future zero-hold arrivals, and power-of-2
    bucketing past the window (40 -> 64, 70 -> 128, 130 -> 256)."""
    arr, hold = _trace(n, n, ties=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = semaphore_admission_window(arr, hold, capacity=4,
                                          window=window, interpret=True)
        got = tsem.AdmissionWindow("cpu", base_window=window)(
            arr, hold, capacity=4, window=window)
    for w, g in zip(want, got):
        _bits_equal(w, g)


def test_window_overflow_warns_once():
    win = tsem.AdmissionWindow("cpu", base_window=8)
    arr, hold = _trace(1, 20)
    with pytest.warns(RuntimeWarning, match="bucketing to 32"):
        win(arr, hold, capacity=2, window=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        win(arr, hold, capacity=2, window=8)


def test_library_ref_backend_plans_like_reference():
    """``SyncLibrary.plan_semaphore`` on the ``ref`` backend (unsorted
    arrivals, returned in the caller's order) against the reference's
    windowed op."""
    rng = np.random.default_rng(3)
    arr = rng.uniform(0, 10, 20).astype(np.float32)
    hold = rng.uniform(1, 5, 20).astype(np.float32)
    plan = SyncLibrary.host_default().plan_semaphore(arr, hold, 3,
                                                     backend="ref")
    perm = np.argsort(arr, kind="stable")
    g, r, w = semaphore_admission_window(arr[perm], hold[perm], capacity=3,
                                         window=32, interpret=True)
    inv = np.argsort(perm, kind="stable")
    _bits_equal(plan.grant, np.asarray(g)[inv])
    _bits_equal(plan.release, np.asarray(r)[inv])
    _bits_equal(plan.waited, np.asarray(w)[inv])
    assert plan.backend == "ref"


def test_capacity_bounds():
    """K 0 is refused; past the kernel's register layout (K 1025) the
    plain version plans like the reference: no cap below the card's
    memory."""
    a = torch.zeros(4)
    with pytest.raises(ValueError, match="capacity"):
        tsem.semaphore_admission(a, a, 0)
    cap = tsem.REGISTER_CAPACITY + 1
    arr, hold = _saturating_trace(7, cap + 200)
    want = sleeping_semaphore_ref(jnp.asarray(arr), jnp.asarray(hold), cap)
    got = tsem.semaphore_admission(torch.from_numpy(arr),
                                   torch.from_numpy(hold), cap)
    assert int(got[2].sum()) > 0
    for w, g in zip(want, got):
        _bits_equal(w, g.numpy())


def _saturating_trace(seed, n):
    """More arrivals than slots inside one hold: the last ones wait."""
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(0.0, 0.5, n)).astype(np.float32),
            rng.integers(1, 9, n).astype(np.float32))


def test_library_ref_backend_plans_past_1024_like_reference():
    """``plan_semaphore(capacity=2048)`` on the port's ``ref`` backend
    returns the JAX ``ref`` backend's plan bit for bit (it raised before
    the cap moved to the CUDA kernel's register layout)."""
    import repro.sync as jsync
    rng = np.random.default_rng(11)
    arr = rng.uniform(0.0, 0.5, 2100).astype(np.float32)
    hold = rng.integers(1, 9, 2100).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jsync.SyncLibrary.host_default().plan_semaphore(
            arr, hold, 2048, backend="ref")
        got = SyncLibrary.host_default().plan_semaphore(arr, hold, 2048,
                                                        backend="ref")
    assert got.backend == "ref" and int(got.waited.sum()) > 0
    for name in ("grant", "release", "waited"):
        _bits_equal(getattr(want, name), getattr(got, name))


def test_wrapper_has_no_fallback_off_the_cpu():
    a = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tsem.semaphore_admission(a, a, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("capacity", [1, 4, 64])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, capacity):
    arr, hold = _trace(capacity, 128)
    before = tsem.SEMAPHORE_ADMISSION.launches
    got = tsem.semaphore_admission(torch.from_numpy(arr).to(cuda_device),
                                   torch.from_numpy(hold).to(cuda_device),
                                   capacity)
    want = tsem.semaphore_admission_plain(torch.from_numpy(arr),
                                          torch.from_numpy(hold), capacity)
    assert tsem.SEMAPHORE_ADMISSION.launches == before + 1
    for w, g in zip(want, got):
        _bits_equal(w.numpy(), g.cpu().numpy())


@pytest.mark.parametrize("capacity", [8, 9, 32, 33, 1024])
@pytest.mark.parametrize("ties", [False, True])
def test_cuda_kernel_bit_equal_at_layout_boundaries(cuda_device, capacity,
                                                    ties):
    """One, two and 32 slots per lane (K 32, 33, 1024), below and above
    the serving engine's K 4, on random and tie-heavy traces, K > N
    included."""
    for n in (1, 64, 1000):
        arr, hold = _trace(capacity + n, n, ties)
        got = tsem.semaphore_admission(
            torch.from_numpy(arr).to(cuda_device),
            torch.from_numpy(hold).to(cuda_device), capacity)
        want = tsem.semaphore_admission_plain(torch.from_numpy(arr),
                                              torch.from_numpy(hold),
                                              capacity)
        for w, g in zip(want, got):
            _bits_equal(w.numpy(), g.cpu().numpy())


@pytest.mark.parametrize("capacity", [1025, 2048])
def test_cuda_kernel_bit_equal_past_register_capacity(cuda_device,
                                                      capacity):
    """The column kernel (slot times in global scratch) on saturating
    traces, so the last arrivals wait, and on K > N."""
    for n in (capacity + 300, 64):
        arr, hold = _saturating_trace(capacity + n, n)
        before = tsem.SEMAPHORE_ADMISSION.launches
        got = tsem.semaphore_admission(
            torch.from_numpy(arr).to(cuda_device),
            torch.from_numpy(hold).to(cuda_device), capacity)
        assert tsem.SEMAPHORE_ADMISSION.launches == before + 1
        want = tsem.semaphore_admission_plain(torch.from_numpy(arr),
                                              torch.from_numpy(hold),
                                              capacity)
        for w, g in zip(want, got):
            _bits_equal(w.numpy(), g.cpu().numpy())


def test_cuda_window_plans_past_register_capacity(cuda_device):
    win = tsem.AdmissionWindow(cuda_device, base_window=4096)
    arr, hold = _saturating_trace(3, 2100)
    want = tsem.AdmissionWindow("cpu", base_window=4096)(arr, hold,
                                                         capacity=2048)
    for _ in range(2):
        got = win(arr, hold, capacity=2048)
        for w, g in zip(want, got):
            _bits_equal(w, g)


def test_cuda_window_plan_is_one_launch(cuda_device):
    win = tsem.AdmissionWindow(cuda_device, base_window=64)
    arr, hold = _trace(2, 40, ties=True)
    want = tsem.AdmissionWindow("cpu", base_window=64)(arr, hold,
                                                       capacity=4)
    for _ in range(3):
        before = tsem.SEMAPHORE_ADMISSION.launches
        got = win(arr, hold, capacity=4)
        assert tsem.SEMAPHORE_ADMISSION.launches == before + 1
        for w, g in zip(want, got):
            _bits_equal(w, g)


def test_cuda_window_plans_from_several_threads(cuda_device):
    """One window's pinned buffers shared by eight threads planning at
    once: each plan gets its own inputs' result."""
    from concurrent.futures import ThreadPoolExecutor
    win = tsem.AdmissionWindow(cuda_device, base_window=64)
    cpu = tsem.AdmissionWindow("cpu", base_window=64)
    traces = [_trace(50 + i, 40, ties=bool(i % 2)) for i in range(8)]
    wants = [cpu(a, h, capacity=4) for a, h in traces]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(5):
            gots = list(pool.map(lambda t: win(*t, capacity=4), traces))
            for got, want in zip(gots, wants):
                for w, g in zip(want, got):
                    _bits_equal(w, g)
