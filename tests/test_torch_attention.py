"""PyTorch port vs the JAX reference: the paged attention functions of
the serving main path, float32, within TOL (max abs).

Writes are compared as whole arenas, not just the live cells: a lane
the reference drops (its ``mode="drop"`` scatter) must leave every cell
of the port's arena untouched too — the drop sentinel ``_DROP_POS``,
sentinel table entries and positions past the table.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as ja
from repro.serve.engine import _DROP_POS as J_DROP_POS
from repro_torch.configs import get_arch
from repro_torch.models import attention as ta
from repro_torch.serve.engine import _DROP_POS

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=0)


def _paged(seed, *, b=4, kv=2, hd=8, ps=4, num_pages=12, p_cap=4):
    """Arena + block tables with ragged allocated prefixes, sentinel
    tails, one fully-sentinel row, and lengths inside each allocation."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    pages = np.full((b, p_cap), num_pages, np.int32)
    lens = np.zeros(b, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i in range(b - 1):
        n = int(rng.integers(1, p_cap + 1))
        pages[i, :n] = perm[used:used + n]
        used += n
        lens[i] = int(rng.integers((n - 1) * ps + 1, n * ps + 1))
    return k, v, pages, lens


def test_drop_sentinel_matches_reference():
    assert _DROP_POS == J_DROP_POS == 2 ** 30


def test_qkv_project_and_attention_out():
    cfg = get_arch("qwen3-14b").reduced()
    jcfg = jget_arch("qwen3-14b").reduced()
    rng = np.random.default_rng(0)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, 32
    w = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
         "wo": (h, hd, d)}
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in w.items()}
    p["q_norm"] = {"scale": rng.uniform(.5, 1.5, hd).astype(np.float32)}
    p["k_norm"] = {"scale": rng.uniform(.5, 1.5, hd).astype(np.float32)}
    pj = {k: ({"scale": jnp.asarray(v["scale"])} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    pt = {k: ({"scale": _t(v["scale"])} if isinstance(v, dict) else _t(v))
          for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    qj, kj, vj = ja.qkv_project(pj, jcfg, jnp.asarray(x), jnp.asarray(pos))
    qt, kt, vt = ta.qkv_project(pt, cfg, _t(x), _t(pos))
    for j, t in ((qj, qt), (kj, kt), (vj, vt)):
        _close(j, t)
    _close(ja.attention_out(pj, qj, h), ta.attention_out(pt, qt, h))


@pytest.mark.parametrize("kv,h", [(1, 4), (2, 4), (4, 4)])
def test_expand_kv(kv, h):
    x = np.random.default_rng(1).standard_normal((2, 3, kv, 8)).astype(
        np.float32)
    _close(ja.expand_kv(jnp.asarray(x), h), ta.expand_kv(_t(x), h), 0)


def test_gather_pages_clips_sentinels():
    k, _, pages, _ = _paged(2)
    _close(ja.gather_pages(jnp.asarray(k), jnp.asarray(pages)),
           ta.gather_pages(_t(k), _t(pages)), 0)


def test_scatter_page_token_whole_arena():
    """Rows write at their length: live rows land, the fully-sentinel
    row, a row whose position is past its table and a row parked at the
    drop sentinel all leave the arena untouched."""
    k, _, pages, lens = _paged(3, b=5)
    pos = lens.copy()
    pos[2] = pages.shape[1] * 4 + 3          # past the table
    pos[3] = _DROP_POS                       # engine's drop sentinel
    val = np.random.default_rng(4).standard_normal(
        (5,) + k.shape[2:]).astype(np.float32)
    want = ja.scatter_page_token(jnp.asarray(k), jnp.asarray(pages),
                                 jnp.asarray(pos), jnp.asarray(val))
    arena = _t(k)
    got = ta.scatter_page_token(arena, _t(pages), _t(pos), _t(val))
    assert got is arena                       # written in place
    _close(want, got, 0)
    assert not np.array_equal(np.asarray(want), k)   # live rows did write


def test_scatter_page_tokens_whole_arena():
    """Chunk form: pad lanes at the drop sentinel, a row whose chunk
    runs into its sentinel tail, a fully-sentinel row."""
    k, _, pages, lens = _paged(5, b=4, p_cap=4)
    c = 6
    pos = np.full((4, c), _DROP_POS, np.int32)
    pos[0, :4] = np.arange(4) + 1
    pos[1, :] = np.arange(c) + max(int(lens[1]) - 3, 0)
    pos[2, :2] = np.arange(2)
    pos[3, :] = np.arange(c)                  # fully-sentinel row
    val = np.random.default_rng(6).standard_normal(
        (4, c) + k.shape[2:]).astype(np.float32)
    want = ja.scatter_page_tokens(jnp.asarray(k), jnp.asarray(pages),
                                  jnp.asarray(pos), jnp.asarray(val))
    got = ta.scatter_page_tokens(_t(k), _t(pages), _t(pos), _t(val))
    _close(want, got, 0)


def test_page_write_plan_masks_every_drop_lane():
    pages = torch.tensor([[0, 1, 9], [9, 9, 9]], dtype=torch.int32)
    pos = torch.tensor([[0, 5, 9, _DROP_POS], [0, 1, 2, 3]],
                       dtype=torch.int32)
    plan = ta.page_write_plan(pages, pos, num_pages=9, page_size=4)
    assert plan.lanes[0].tolist() == [0, 0] and plan.lanes[1].tolist() == [
        0, 1]
    assert plan.page.tolist() == [0, 1] and plan.offset.tolist() == [0, 1]


@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention(window):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 4, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 4, 8)).astype(np.float32)
    cl = np.array([1, 6, 10], np.int32)
    _close(ja.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(cl),
                               window=window),
           ta.decode_attention(_t(q), _t(kc), _t(vc), _t(cl),
                               window=window))


@pytest.mark.parametrize("window", [None, 3])
def test_chunk_decode_attention(window):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    vc = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    qp = np.array([[0, 1, 2, 3], [5, 6, 7, 8]], np.int32)
    _close(ja.chunk_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(qp),
                                     window=window),
           ta.chunk_decode_attention(_t(q), _t(kc), _t(vc), _t(qp),
                                     window=window))


@pytest.mark.parametrize("kv,h", [(1, 4), (2, 4), (4, 4)])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_attention_gather(kv, h, window):
    k, v, pages, lens = _paged(9, kv=kv)
    q = np.random.default_rng(10).standard_normal(
        (4, 1, h, 8)).astype(np.float32)
    cfg = types.SimpleNamespace(num_heads=h)
    args_j = [jnp.asarray(a) for a in (q, k, v, pages, lens)]
    args_t = [_t(a) for a in (q, k, v, pages, lens)]
    _close(ja.paged_decode_attention(None, cfg, *args_j, window=window,
                                     impl="gather"),
           ta.paged_decode_attention(None, cfg, *args_t, window=window,
                                     impl="gather"))


@pytest.mark.parametrize("kv,h", [(1, 4), (2, 4)])
def test_paged_decode_attention_fused_vs_reference_gather(kv, h):
    """The port's fused path (its plain version on the CPU) against the
    reference's gather path, on the live rows the engine reads."""
    k, v, pages, lens = _paged(11, kv=kv)
    q = np.random.default_rng(12).standard_normal(
        (4, 1, h, 8)).astype(np.float32)
    cfg = types.SimpleNamespace(num_heads=h)
    want = ja.paged_decode_attention(
        None, cfg, *[jnp.asarray(a) for a in (q, k, v, pages, lens)],
        window=None, impl="gather")
    got = ta.paged_decode_attention(
        None, cfg, *[_t(a) for a in (q, k, v, pages, lens)], window=None,
        impl="fused")
    live = (pages < k.shape[0]).any(axis=1) & (lens > 0)
    _close(np.asarray(want)[live], got.numpy()[live])
    assert np.all(got.numpy()[~(pages < k.shape[0]).any(axis=1)] == 0)


def test_paged_decode_attention_rejects_unknown_impl():
    cfg = types.SimpleNamespace(num_heads=2)
    with pytest.raises(ValueError, match="unknown paged decode impl"):
        ta.paged_decode_attention(
            None, cfg, torch.zeros(1, 1, 2, 8), torch.zeros(2, 2, 1, 8),
            torch.zeros(2, 2, 1, 8), torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), window=None, impl="flash")


@pytest.mark.parametrize("window", [None, 4])
def test_paged_chunk_attention(window):
    k, v, pages, _ = _paged(13, kv=2)
    rng = np.random.default_rng(14)
    q = rng.standard_normal((4, 3, 4, 8)).astype(np.float32)
    qp = np.stack([np.arange(3) + int(rng.integers(0, 10))
                   for _ in range(4)]).astype(np.int32)
    cfg = types.SimpleNamespace(num_heads=4)
    _close(ja.paged_chunk_attention(
        None, cfg, *[jnp.asarray(a) for a in (q, k, v, pages, qp)],
        window=window),
        ta.paged_chunk_attention(
            None, cfg, *[_t(a) for a in (q, k, v, pages, qp)],
            window=window))
