"""The CUDA paged-decode kernel's split over table entries, on the CPU.

The kernel cannot run here, so its decomposition is held to the JAX
package's ``fused_paged_decode`` (Pallas, interpret mode) in torch:
``plan_splits`` / ``split_ranges`` (how the wrapper cuts each (row, kv
head), from the shapes and the SM count alone) and
``paged_decode_split_model`` (per-split partials ``(m, l, acc)``, then the
fixed-order log-sum-exp merge that the kernel's last-arriving CTA does).
Float32 within TOL (max abs). Splits of 1, 2, 3 and one per table entry;
empty splits, dead and length-0 rows (exact zeros), windows, negative
table entries, page sizes {1, 4, 16} and the GQA grid; head dim 256 at
gemma3-1b's grouping (one kv head, G 4), with windows, and the plan at
the CTAs per SM of each kernel variant.

``test_cuda_*`` need a card and skip without one; ``chip_smoke.py``
phase 2 holds the kernel itself to the plain version and to this model.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import fused_paged_decode
from repro_torch.kernels import paged_attention as tpa

TOL = 1e-5
P_CAP = 5


def _case(seed, *, b, kv, g, hd, ps, num_pages, p_cap, max_len=None,
          dead_row=False, negative=False):
    """Ragged lengths (row 1 empty when b > 2), allocated prefixes with
    sentinel tails, optionally a fully-sentinel last row and negative
    entries inside live prefixes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    hi = max_len if max_len is not None else p_cap * ps
    lens = rng.integers(1, hi + 1, size=b).astype(np.int32)
    if b > 2:
        lens[1] = 0
    pages = np.full((b, p_cap), num_pages, np.int32)
    for i in range(b):
        need = -(-int(lens[i]) // ps)
        if need:
            pages[i, :need] = rng.choice(num_pages, size=need, replace=False)
    if negative:
        lens[0] = p_cap * ps
        pages[0] = rng.choice(num_pages, size=p_cap, replace=False)
        pages[0, 1] = -1
        pages[0, 3] = -5
        pages[0, 2] = num_pages           # a sentinel between live pages
    if dead_row:
        pages[-1] = num_pages
    return q, k, v, pages, lens


@functools.lru_cache(maxsize=None)
def _instance(seed, window=None, **kw):
    """(numpy inputs, JAX kernel output) for one instance, computed once."""
    arrays = _case(seed, **kw)
    want = fused_paged_decode(*[jnp.asarray(a) for a in arrays],
                              window=window, interpret=True)
    return arrays, np.asarray(want)


def _model(arrays, splits, window=None):
    p_cap = arrays[3].shape[1]
    pps = -(-p_cap // splits)
    return tpa.paged_decode_split_model(
        *[torch.from_numpy(a) for a in arrays], pages_per_split=pps,
        window=window).numpy()


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("p_cap,b,kv,sms", [
    (35, 4, 8, 132), (256, 4, 8, 132), (1, 1, 1, 132), (5, 64, 8, 132),
    (7, 1, 1, 132), (1000, 1, 1, 132), (35, 4, 8, 1), (13, 3, 2, 16)])
def test_plan_covers_the_table_once(p_cap, b, kv, sms):
    splits, pps = tpa.plan_splits(p_cap, b, kv, sms)
    ranges = tpa.split_ranges(p_cap, pps)
    assert len(ranges) == splits
    assert 1 <= splits <= tpa.MAX_SPLITS
    covered = [j for j0, j1 in ranges for j in range(j0, j1)]
    assert covered == list(range(p_cap))          # in order, exactly once
    assert all(j1 > j0 for j0, j1 in ranges)      # no split without entries


def test_plan_reads_no_length():
    """The plan is made from shapes and the SM count: reading cache_len
    would wait on the card in every layer of every decode step."""
    params = list(inspect.signature(tpa.plan_splits).parameters)
    assert params == ["table_width", "batch", "kv_heads", "sm_count",
                      "ctas_per_sm"]


@pytest.mark.parametrize("p_cap,want_splits", [(35, 7), (256, 8)])
def test_plan_aims_at_two_ctas_per_sm(p_cap, want_splits):
    """The main path's table (35 entries) and the long-context row's
    (256), B 4, KV 8, on 132 SMs: one wave of between one and two CTAs
    per SM."""
    splits, _ = tpa.plan_splits(p_cap, 4, 8, 132)
    assert splits == want_splits
    assert 132 < splits * 4 * 8 <= 2 * 132


@pytest.mark.parametrize("hd,dtype,want", [
    (16, torch.bfloat16, 2), (32, torch.bfloat16, 2), (128, torch.bfloat16, 2),
    (256, torch.bfloat16, 1), (16, torch.float32, 2), (32, torch.float32, 2),
    (128, torch.float32, 1), (256, torch.float32, 1)])
def test_ctas_per_sm_by_variant(hd, dtype, want):
    """The CTAs per SM each variant's shared memory allows (at most two):
    bf16 hd 128 rings 96 KB, so two fit in the SM's 228 KB; hd 256 rings
    128 KB in both dtypes (2 stages of 16 KB a warp in bf16, 1 of 32 KB
    in fp32), and fp32 hd 128 128 KB: one."""
    assert tpa.ctas_per_sm(hd, dtype) == want


@pytest.mark.parametrize("p_cap,b,want", [(128, 4, (32, 4)), (256, 4, (32, 8)),
                                          (35, 4, (18, 2)), (5, 1, (5, 1))])
def test_plan_at_hd256_fills_one_cta_per_sm(p_cap, b, want):
    """gemma3-1b's decode (one kv head) at one CTA per SM: phase 10's
    table (128 entries) and the long row's (256), B 4, on 132 SMs — one
    wave, every SM at most one CTA."""
    ctas = tpa.ctas_per_sm(256, torch.bfloat16)
    splits, pps = tpa.plan_splits(p_cap, b, 1, 132, ctas)
    assert (splits, pps) == want
    assert splits * b <= 132


# ----------------------------------------------------------- the split model
@pytest.mark.parametrize("splits", [1, 2, 4, P_CAP])
@pytest.mark.parametrize("window", [None, 5, 12])
def test_split_model_hd256_matches_pallas(window, splits):
    """gemma3-1b's grouping (one kv head, four query heads) at head dim
    256: windows shorter and longer than a row, a dead row, a length-0
    row, sentinel tails."""
    arrays, want = _instance(256, window=window, b=4, kv=1, g=4, hd=256,
                             ps=4, num_pages=24, p_cap=P_CAP, dead_row=True)
    got = _model(arrays, splits, window)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.all(got[-1] == 0.0) and np.all(got[1] == 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, P_CAP])
@pytest.mark.parametrize("kv,g", [(8, 1), (2, 4), (1, 8), (8, 5)])
@pytest.mark.parametrize("ps", [1, 4, 16])
def test_split_model_matches_pallas(ps, kv, g, splits):
    arrays, want = _instance(ps * 10 + kv, b=4, kv=kv, g=g, hd=16, ps=ps,
                             num_pages=24, p_cap=P_CAP, dead_row=True)
    got = _model(arrays, splits)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.all(got[-1] == 0.0)      # all-sentinel row: exact zeros
    assert np.all(got[1] == 0.0)       # length-0 row: exact zeros


@pytest.mark.parametrize("splits", [1, 2, 3, P_CAP])
@pytest.mark.parametrize("window", [2, 5, 11])
def test_split_model_sliding_window(window, splits):
    """Splits wholly before the window are empty partials."""
    arrays, want = _instance(7, window=window, b=3, kv=2, g=2, hd=16, ps=4,
                             num_pages=16, p_cap=P_CAP)
    np.testing.assert_allclose(_model(arrays, splits, window=window), want,
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_model_empty_splits(splits):
    """Short rows in a wide table: the later splits hold no live position
    and must add nothing (no NaN from exp(NEG_INF - NEG_INF))."""
    arrays, want = _instance(21, b=4, kv=2, g=4, hd=16, ps=4, num_pages=40,
                             p_cap=8, max_len=5)
    got = _model(arrays, splits)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, P_CAP])
def test_split_model_negative_entries(splits):
    """A negative table entry reads page 0 and is live; only entries >=
    num_pages are sentinels (the TPU kernel's clip)."""
    arrays, want = _instance(13, b=3, kv=2, g=4, hd=16, ps=4, num_pages=16,
                             p_cap=P_CAP, negative=True)
    np.testing.assert_allclose(_model(arrays, splits), want, atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("splits", [1, 3])
def test_split_model_all_rows_dead(splits):
    q, k, v, pages, lens = _case(5, b=3, kv=2, g=2, hd=16, ps=4,
                                 num_pages=8, p_cap=P_CAP)
    pages[:] = 8
    lens[2] = 0
    got = _model((q, k, v, pages, lens), splits)
    assert np.all(got == 0.0)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_split_model_bit_equal_launches(cuda_device,
                                                            dtype):
    arrays = _case(3, b=4, kv=8, g=5, hd=128, ps=16, num_pages=40, p_cap=9,
                   negative=True)
    q, k, v, pages, lens = [torch.from_numpy(a).to(cuda_device)
                            for a in arrays]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    splits, pps = tpa.plan_splits(9, 4, 8, tpa.sm_count(cuda_device),
                                  tpa.ctas_per_sm(128, dtype))
    got = tpa.paged_decode(q, k, v, pages, lens)
    again = tpa.paged_decode(q, k, v, pages, lens)
    want = tpa.paged_decode_split_model(q, k, v, pages, lens,
                                        pages_per_split=pps)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    tol = TOL if dtype == torch.float32 else 2e-3
    ulp = 0 if dtype == torch.float32 else 2.0 ** -7
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= tol + ulp * want.abs()).all())


@pytest.mark.parametrize("g,hd", [(9, 32), (4, 64), (2, 512)])
def test_cuda_kernel_rejects_unsupported_shapes(cuda_device, g, hd):
    q = torch.zeros(1, 1, g, hd, device=cuda_device)
    arena = torch.zeros(2, 4, 1, hd, device=cuda_device)
    pages = torch.zeros(1, 1, dtype=torch.int32, device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode(q, arena, arena, pages, lens)


@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hd256_matches_plain_and_split_model(cuda_device, dtype,
                                                  window):
    """gemma3-1b's decode shape on the card: hd 256, one kv head, G 4,
    page 16, row 0 past the window, a length-0 row; bf16 within 2e-3 +
    1 ulp, f32 within 1e-5, two launches bit-equal."""
    arrays = _case(17, b=4, kv=1, g=4, hd=256, ps=16, num_pages=80,
                   p_cap=64, max_len=1016)
    q, k, v, pages, lens = [torch.from_numpy(a).to(cuda_device)
                            for a in arrays]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lens[0] = 1000
    pages[0, :63] = torch.randperm(80, generator=torch.Generator().manual_seed(
        17))[:63].to(device=cuda_device, dtype=torch.int32)
    splits, pps = tpa.plan_splits(64, 4, 1, tpa.sm_count(cuda_device),
                                  tpa.ctas_per_sm(256, dtype))
    got = tpa.paged_decode(q, k, v, pages, lens, window=window)
    again = tpa.paged_decode(q, k, v, pages, lens, window=window)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), again.view(bits))
    tol = TOL if dtype == torch.float32 else 2e-3
    ulp = 0 if dtype == torch.float32 else 2.0 ** -7
    got = got.float()
    for want in (tpa.paged_decode_plain(q, k, v, pages, lens, window=window),
                 tpa.paged_decode_split_model(q, k, v, pages, lens,
                                              pages_per_split=pps,
                                              window=window)):
        want = want.float()
        assert bool(((got - want).abs() <= tol + ulp * want.abs()).all())
    assert bool((got[1] == 0).all())
