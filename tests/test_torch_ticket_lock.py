"""Algorithm-3 ticket mutex: the port's plain version and windowed
planners against the JAX package's Pallas kernel (interpret mode) and
its pure-jnp oracle — grant order and turn trace exact, the
order-sensitive chain within the reference's own tolerance (rtol 2e-4,
atol 1e-4: tests/test_kernels.py); the windowed, batched-ledger and
bounded-wait forms equal.

The CUDA kernel runs only on a card (``test_cuda_*`` skip without one;
``chip_smoke.py`` phase 2 checks it bit-equal on the card every run).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ticket_lock import ops as jops
from repro.kernels.ticket_lock.ref import ticket_lock_ref
from repro_torch.kernels import ticket_lock as ttl

TOL = dict(rtol=2e-4, atol=1e-4)


def _trace(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.permutation(n).astype(np.int32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("n", [2, 9, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_and_oracle(n, seed):
    arr, m, b = _trace(seed * 100 + n, n)
    got = ttl.ticket_lock(torch.from_numpy(arr), torch.from_numpy(m),
                          torch.from_numpy(b))
    for want in (jops.ticket_lock_run(jnp.asarray(arr), jnp.asarray(m),
                                      jnp.asarray(b), interpret=True),
                 ticket_lock_ref(jnp.asarray(arr), jnp.asarray(m),
                                 jnp.asarray(b))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(float(got[2]), float(want[2]), **TOL)
    # FIFO and the Algorithm-3 invariant (observed turn == ticket)
    np.testing.assert_array_equal(got[0].numpy(), arr)
    np.testing.assert_array_equal(got[1].numpy(), np.arange(n))
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[2].dtype == torch.float32 and got[2].dim() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_chain_is_the_float32_fold(seed):
    """The chain is a float32 multiply then a float32 add per ticket, in
    ticket order — what the CUDA kernel computes with __fmul_rn /
    __fadd_rn, so the two are bit-equal."""
    arr, m, b = _trace(seed, 300)
    acc = np.float32(0.0)
    for t in range(300):
        acc = np.float32(np.float32(acc * m[t]) + b[t])
    got = ttl.ticket_lock_plain(torch.from_numpy(arr), torch.from_numpy(m),
                                torch.from_numpy(b))[2]
    assert np.float32(got).view(np.int32) == acc.view(np.int32)


@pytest.mark.parametrize("n,window", [(0, 32), (5, 32), (32, 32), (33, 32),
                                      (70, 16)])
def test_window_matches_reference_window(n, window):
    arr, m, b = _trace(n + window, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jops.ticket_lock_window(arr, m, b, window=window,
                                       use_kernel=False)
        got = ttl.ticket_lock_window(arr, m, b, window=window, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), **TOL)
    assert got[0].shape == (n,)


def test_window_defaults_to_identity_chain():
    g, t, acc = ttl.ticket_lock_window([2, 0, 1], device="cpu")
    assert g.tolist() == [2, 0, 1] and t.tolist() == [0, 1, 2]
    assert float(acc) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_window_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 50))
    arr = rng.permutation(n).astype(np.int32)
    counts = rng.integers(0, 9, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jops.ticket_lock_batch_window(arr, counts, use_kernel=False)
        got = ttl.ticket_lock_batch_window(arr, counts, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert got[2] == int(counts.sum()) and got[3] == (n, got[2])


def test_batch_window_rejects_bad_counts():
    with pytest.raises(ValueError, match="one entry per requester"):
        ttl.ticket_lock_batch_window([0, 1], [1], device="cpu")
    with pytest.raises(ValueError, match="negative"):
        ttl.ticket_lock_batch_window([0, 1], [1, -1], device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_bounded_oracle_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 12
    arrivals = rng.uniform(0, 2, n).astype(np.float32)
    holds = rng.uniform(0.5, 1.5, n).astype(np.float32)
    timeouts = rng.choice([0.0, 0.7, 2.5, np.inf], size=n).astype(
        np.float32)
    for got, want in zip(
            ttl.ticket_lock_bounded_oracle(arrivals, holds, timeouts),
            jops.ticket_lock_bounded_oracle(arrivals, holds, timeouts)):
        np.testing.assert_array_equal(got, want)


def test_wrapper_checks_shapes_and_devices():
    a = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4)
    with pytest.raises(ValueError, match=r"expected \(N,\)"):
        ttl.ticket_lock(a, f[:3], f)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ttl.ticket_lock(a.to("meta"), meta, meta)


def test_windows_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttl.ticket_lock_window([0, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttl.ticket_lock_batch_window([0, 1], [1, 2])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 64, 1024])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, n):
    arr, m, b = _trace(n, n)
    before = ttl.TICKET_LOCK.launches
    got = ttl.ticket_lock(*(torch.from_numpy(x).to(cuda_device)
                            for x in (arr, m, b)))
    want = ttl.ticket_lock_plain(torch.from_numpy(arr), torch.from_numpy(m),
                                 torch.from_numpy(b))
    assert ttl.TICKET_LOCK.launches == before + 1
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [33, 4096])
def test_cuda_kernel_bit_equal_when_slots_serve_many(cuda_device, n):
    """More requesters than the CTA's 32 requester warps: N 33 gives
    warp 0 a second requester, N 4096 each warp 128, served in order."""
    arr, m, b = _trace(n + 1, n)
    got = ttl.ticket_lock(*(torch.from_numpy(x).to(cuda_device)
                            for x in (arr, m, b)))
    want = ttl.ticket_lock_plain(torch.from_numpy(arr), torch.from_numpy(m),
                                 torch.from_numpy(b))
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def test_cuda_window_plan_is_one_launch(cuda_device):
    arr, m, b = _trace(5, 20)
    want = ttl.ticket_lock_window(arr, m, b, device="cpu")
    for _ in range(3):
        before = ttl.TICKET_LOCK.launches
        got = ttl.ticket_lock_window(arr, m, b, device=cuda_device)
        assert ttl.TICKET_LOCK.launches == before + 1
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert np.float32(got[2]).view(np.int32) == \
            np.float32(want[2]).view(np.int32)


@pytest.mark.parametrize("n", [ttl.STAGED_N + 1, 2 * ttl.STAGED_N])
def test_cuda_kernel_bit_equal_past_its_staging(cuda_device, n):
    """Past the shared-memory staging (N 16385, 32768) grant and trace go
    straight to global memory: still bit-equal, and the window plans."""
    arr, m, b = _trace(n, n)
    got = ttl.ticket_lock(*(torch.from_numpy(x).to(cuda_device)
                            for x in (arr, m, b)))
    want = ttl.ticket_lock_plain(torch.from_numpy(arr), torch.from_numpy(m),
                                 torch.from_numpy(b))
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got_w = ttl.ticket_lock_window(arr, m, b, device=cuda_device)
        want_w = ttl.ticket_lock_window(arr, m, b, device="cpu")
    np.testing.assert_array_equal(got_w[0], want_w[0])
    np.testing.assert_array_equal(got_w[1], want_w[1])


def test_cuda_window_plans_from_several_threads(cuda_device):
    """The window's pinned buffers are shared: plans made at once from
    eight threads each get their own inputs' result."""
    from concurrent.futures import ThreadPoolExecutor
    traces = [_trace(40 + i, 20) for i in range(8)]
    wants = [ttl.ticket_lock_window(*t, device="cpu") for t in traces]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(5):
            gots = list(pool.map(lambda t: ttl.ticket_lock_window(
                *t, device=cuda_device), traces))
            for got, want in zip(gots, wants):
                np.testing.assert_array_equal(got[0], want[0])
                assert np.float32(got[2]).view(np.int32) == \
                    np.float32(want[2]).view(np.int32)
