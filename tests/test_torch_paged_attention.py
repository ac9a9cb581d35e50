"""Fused paged decode: the port's plain version (what a CPU tensor runs)
and its model adapter against the JAX package's Pallas kernel in
interpret mode and its pure-jnp oracle, on the grid of
``tests/test_paged_attention.py``: page sizes {1, 4, 16} x GQA {1:1,
4:1, 8:1}, ragged last pages, sentinel tails, all-sentinel rows (exact
zeros), sliding windows. Float32, within TOL (max abs).

The CUDA kernel itself runs only on a card: ``test_cuda_kernel_*`` skip
without one; ``chip_smoke.py`` phase 2 holds it against the plain
version on the card on every run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (fused_paged_decode,
                                           paged_decode_fused,
                                           paged_decode_ref)
from repro_torch.kernels import paged_attention as tpa

TOL = 1e-5


def _case(seed, *, b, kv, g, hd, ps, num_pages, p_cap, dead_row=False):
    """The reference suite's instance generator: ragged lengths (a
    zero-length row when b > 2), allocated prefixes with sentinel
    tails, optionally one fully-sentinel row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    lens = rng.integers(1, p_cap * ps + 1, size=b).astype(np.int32)
    if b > 2:
        lens[1] = 0
    pages = np.full((b, p_cap), num_pages, np.int32)
    for i in range(b):
        need = -(-int(lens[i]) // ps) if lens[i] else 0
        if need:
            pages[i, :need] = rng.choice(num_pages, size=need, replace=False)
    if dead_row:
        pages[-1] = num_pages
    return q, k, v, pages, lens


def _both(arrays, window=None):
    q, k, v, pages, lens = arrays
    ja = [jnp.asarray(a) for a in arrays]
    want_kernel = fused_paged_decode(*ja, window=window, interpret=True)
    want_ref = paged_decode_ref(*ja, window=window)
    got = tpa.paged_decode(*[torch.from_numpy(a) for a in arrays],
                           window=window)
    return np.asarray(want_kernel), np.asarray(want_ref), got.numpy()


@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("kv,g", [(8, 1), (2, 4), (1, 8)])
def test_plain_matches_pallas_across_pages_and_gqa(ps, kv, g):
    arrays = _case(ps * 10 + kv, b=4, kv=kv, g=g, hd=16, ps=ps,
                   num_pages=24, p_cap=5, dead_row=True)
    kern, ref, got = _both(arrays)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert np.all(got[-1] == 0.0)             # all-sentinel row: zeros


@pytest.mark.parametrize("window", [2, 5])
def test_plain_matches_pallas_sliding_window(window):
    kern, ref, got = _both(_case(7, b=3, kv=2, g=2, hd=8, ps=4,
                                 num_pages=16, p_cap=4), window=window)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("last", [1, 2, 3, 4])
def test_plain_ragged_last_page(last):
    ps = 4
    q, k, v, pages, _ = _case(100 + last, b=2, kv=1, g=2, hd=8, ps=ps,
                              num_pages=8, p_cap=3)
    lens = np.array([ps + last, 2 * ps + last], np.int32)
    kern, ref, got = _both((q, k, v, pages, lens))
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)


def test_plain_negative_entries_match_pallas():
    """Only an entry >= num_pages is a sentinel: the TPU kernel clips a
    negative entry to page 0 and reads it as live, and so must the plain
    version (and the CUDA kernel, held to it in chip_smoke.py)."""
    q, k, v, pages, lens = _case(13, b=3, kv=2, g=4, hd=16, ps=4,
                                 num_pages=16, p_cap=5)
    lens[0] = 20
    pages[0] = [3, -1, 16, -5, 7]     # two negative entries, one sentinel
    lens[2] = max(int(lens[2]), 5)
    pages[2, :2] = [-2, 9]
    kern, ref, got = _both((q, k, v, pages, lens))
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    assert np.abs(got[0]).max() > 0


def test_adapter_matches_reference_adapter():
    """[B,1,H,hd] in and out, kv-major grouping, against the reference's
    ``paged_decode_fused`` (interpret mode)."""
    q, k, v, pages, lens = _case(5, b=3, kv=2, g=4, hd=8, ps=4,
                                 num_pages=10, p_cap=3)
    qh = q.reshape(3, 1, 8, 8)
    want = paged_decode_fused(jnp.asarray(qh), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pages), jnp.asarray(lens), 8,
                              interpret=True)
    got = tpa.paged_decode_fused(torch.from_numpy(qh), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(pages),
                                 torch.from_numpy(lens), 8)
    assert tuple(got.shape) == (3, 1, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_adapter_rejects_padded_heads():
    """Padded query heads (the ``'pad'`` head plan: 6 for a 4-head
    model) no longer raise: the model's 4 heads go to the kernel, the
    padded 2 come back as zeros, as the reference's adapter does (held
    to it in tests/test_torch_head_plans.py)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 1, 6, 8)).astype(
        np.float32))
    arena = torch.from_numpy(rng.standard_normal((2, 4, 2, 8)).astype(
        np.float32))
    args = (arena, arena, torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 4)
    got = tpa.paged_decode_fused(q, *args)
    assert tuple(got.shape) == (1, 1, 6, 8)
    assert torch.equal(got[:, :, :4],
                       tpa.paged_decode_fused(q[:, :, :4], *args))
    assert not got[:, :, 4:].any()


@pytest.mark.parametrize("window", [None, 5, 12])
def test_plain_hd256_matches_pallas(window):
    """gemma3-1b's grouping at head dim 256 (one kv head, G 4): windows
    shorter and longer than the rows, dead and length-0 rows (exact
    zeros), sentinel tails — the plain version against the Pallas kernel
    and the oracle."""
    kern, ref, got = _both(_case(25, b=4, kv=1, g=4, hd=256, ps=4,
                                 num_pages=24, p_cap=6, dead_row=True),
                           window)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert np.all(got[1] == 0.0) and np.all(got[3] == 0.0)


def test_wrapper_has_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    meta = [torch.empty(s, device="meta") for s in
            ((1, 1, 1, 8), (2, 4, 1, 8), (2, 4, 1, 8))]
    pages = torch.empty((1, 1), dtype=torch.int32, device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tpa.paged_decode(*meta, pages, lens)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    q, k, v, pages, lens = [torch.from_numpy(a).to(cuda_device) for a in
                            _case(3, b=4, kv=2, g=4, hd=32, ps=4,
                                  num_pages=16, p_cap=5, dead_row=True)]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = tpa.PAGED_DECODE.launches
    got = tpa.paged_decode(q, k, v, pages, lens).float()
    want = tpa.paged_decode_plain(q, k, v, pages, lens).float()
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE.launches == before + 1
    tol = TOL if dtype == torch.float32 else 2e-3
    ulp = 0 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got - want).abs() <= tol + ulp * want.abs()).all())
