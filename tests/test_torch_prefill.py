"""One-shot prefill and the contiguous cache, held to the JAX package on
the reduced qwen3-14b (float32, highest matmul precision, the
reference's weights through the bridge, inputs from a numpy seed):

* ``blocked_attention`` / ``full_attention`` against the reference's
  (causal, windowed, several block pairs, GQA): max abs <= 1e-5;
* ``block_forward`` (its residual output at its own RMS scale, its K/V
  absolutely), ``LM.forward`` logits, ``LM.prefill`` logits and cache
  with and without ``length=``: max abs <= 1e-4, the tolerance of the
  existing ``decode_step`` checks;
* the contiguous ``decode_step`` at per-row and scalar lengths,
  including a row at ``cache_len == max_len`` (its write drops, as the
  reference's ``mode="drop"`` scatter) and a scalar length at
  ``max_len`` (the write is clamped onto the last position, as
  ``dynamic_update_slice`` clamps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import tree_map

TOL = 1e-4
ATT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def models():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=0)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("nq,nk,cq,ck,causal,window", [
    (1, 1, 16, 16, True, None), (3, 3, 8, 8, True, None),
    (3, 6, 8, 4, True, 5), (4, 2, 4, 8, True, 3), (2, 3, 6, 4, False, None)])
def test_pair_list_matches_reference(nq, nk, cq, ck, causal, window):
    assert tattn._pair_list(nq, nk, cq, ck, causal, window) == \
        jattn._pair_list(nq, nk, cq, ck, causal, window)


@pytest.mark.parametrize("s,q_chunk,kv_chunk,causal,window", [
    (16, 1024, 1024, True, None),     # one block pair (the serving size)
    (24, 8, 8, True, None),           # the triangle of 3 x 3 blocks
    (24, 8, 4, True, 5),              # a sliding window over 3 x 6 blocks
    (20, 4, 8, True, 3),              # blocks that do not divide evenly
    (12, 4, 4, False, None)])         # every pair
def test_blocked_attention_matches_reference(s, q_chunk, kv_chunk, causal,
                                             window):
    rng = np.random.default_rng(s + q_chunk + kv_chunk)
    q, k, v = (rng.standard_normal((2, s, 4, 32)).astype(np.float32)
               for _ in range(3))
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)
    got = tattn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
    _close(got, want, ATT_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_full_attention_gqa_matches_reference(window):
    """Two query heads per kv head (the reduced config has none), so the
    expansion before ``blocked_attention`` is exercised."""
    jcfg = dataclasses.replace(jget_arch("qwen3-14b").reduced(),
                               num_kv_heads=2)
    tcfg = dataclasses.replace(get_arch("qwen3-14b").reduced(),
                               num_kv_heads=2)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 19, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 19, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jattn.full_attention(None, jcfg, *map(jnp.asarray, (q, k, v)),
                                causal=True, window=window)
    got = tattn.full_attention(None, tcfg, *map(torch.from_numpy, (q, k, v)),
                               causal=True, window=window)
    _close(got, want, ATT_TOL)


# ---------------------------------------------------------------- blocks
def test_block_forward_matches_reference(models):
    jm, jp, tm, tp = models
    cfg_j, cfg_t = jm.cfg, tm.cfg
    layer_j = jax.tree_util.tree_map(lambda a: a[0],
                                     jp["periods"]["layer_0"])
    layer_t = tree_map(lambda a: a[0], tp["periods"]["layer_0"])
    # the model's own input scale: embedding rows of random tokens
    x = np.asarray(jp["embed"]["tokens"])[_tokens(5, 2, 11)]
    pos = np.tile(np.arange(11), (2, 1))
    jx, jc, _ = jblocks.block_forward(layer_j, jnp.asarray(x), cfg_j, "attn",
                                      False, jnp.asarray(pos))
    tx, tc, aux = tblocks.block_forward(layer_t, torch.from_numpy(x), cfg_t,
                                        "attn", False, torch.from_numpy(pos))
    # the residual stream leaves the block at an RMS of ~1e3 (the
    # reference's init gives stacked weights std 1/sqrt(n_periods)), so
    # it is held to TOL at its own scale; K and V, and the model's
    # logits (after the final norm) below, absolutely
    scale = float(np.sqrt(np.mean(np.square(np.asarray(jx)))))
    assert scale > 1.0
    _close(tx / scale, np.asarray(jx) / scale)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert aux == {}


# -------------------------------------------------------------------- LM
def test_forward_logits_match_reference(models):
    jm, jp, tm, tp = models
    tok = _tokens(1, 3, 13)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    assert tl.shape == (3, 13, 512) and aux == {}
    _close(tl, jl)


def _cache_close(tc, jc):
    for name in ("k", "v"):
        _close(tc["periods"]["layer_0"][name],
               jc["periods"]["layer_0"][name])
    assert np.array_equal(np.asarray(tc["len"]), np.asarray(jc["len"]))


@pytest.mark.parametrize("max_len", [None, 21])
def test_prefill_matches_reference(models, max_len):
    """Logits of the last position, the K/V cache (zero-padded to
    ``max_len`` on the time axis) and the scalar length."""
    jm, jp, tm, tp = models
    tok = _tokens(2, 2, 9)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=max_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                        max_len=max_len)
    _close(tl, jl)
    _cache_close(tc, jc)
    assert tc["periods"]["layer_0"]["k"].shape[2] == (max_len or 9)
    assert tc["len"].dim() == 0


def test_prefill_with_length_matches_reference(models):
    """Right-padded prompts: logits at ``clip(length - 1, 0, S - 1)`` per
    row (a zero length clips to position 0), ``len`` the vector."""
    jm, jp, tm, tp = models
    tok = _tokens(3, 4, 8)
    length = np.array([8, 5, 1, 0], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=16,
                        length=jnp.asarray(length))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, max_len=16,
                        length=torch.from_numpy(length))
    _close(tl, jl)
    _cache_close(tc, jc)


def test_pad_cache_refuses_a_shorter_max_len(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="shorter than the prompt"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 6), dtype=torch.int32)},
                   max_len=4)


def _contiguous_pair(jm, jp, tm, tp, tok, max_len, length=None):
    kw = {} if length is None else {"length": length}
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=max_len,
                       **({k: jnp.asarray(v) for k, v in kw.items()}))
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                       max_len=max_len,
                       **({k: torch.from_numpy(v) for k, v in kw.items()}))
    return jc, tc


def test_decode_vector_lengths_drop_past_max_len(models):
    """Per-row lengths 3, 7, 10 in a 10-long cache: rows 0 and 1 write
    and attend at their depth; row 2 (a retired slot drifting past the
    row) writes nothing, as the reference's dropping scatter — three
    steps, logits and caches within TOL, row 2's cache unchanged."""
    jm, jp, tm, tp = models
    tok = _tokens(4, 3, 10)
    jc, tc = _contiguous_pair(jm, jp, tm, tp, tok, 10,
                              np.array([3, 7, 10], np.int32))
    before = tc["periods"]["layer_0"]["k"][:, 2].clone()
    nxt = np.array([5, 6, 7], np.int32)
    jdec = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jc = jdec(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _cache_close(tc, jc)
        nxt = tl.argmax(-1).numpy().astype(np.int32)
        assert np.array_equal(nxt, np.asarray(jnp.argmax(jl, -1)))
    assert tc["len"].tolist() == [6, 10, 13]
    assert torch.equal(tc["periods"]["layer_0"]["k"][:, 2], before)


def test_decode_scalar_length_clamps_at_max_len(models):
    """The legacy engine's scalar length: two steps from S 6 in an
    8-long cache fill positions 6 and 7; the third, at ``len == max_len``,
    overwrites position 7 (the reference's ``dynamic_update_slice``
    clamps its start) instead of dropping."""
    jm, jp, tm, tp = models
    tok = _tokens(5, 2, 6)
    jc, tc = _contiguous_pair(jm, jp, tm, tp, tok, 8)
    nxt = np.array([1, 2], np.int32)
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        if step == 2:
            k7 = tc["periods"]["layer_0"]["k"][:, :, 7].clone()
        jl, jc = jdec(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _cache_close(tc, jc)
        nxt = tl.argmax(-1).numpy().astype(np.int32)
    assert int(tc["len"]) == 9
    assert not torch.equal(tc["periods"]["layer_0"]["k"][:, :, 7], k7)


def test_prefill_chunk_on_the_contiguous_cache(models):
    """Chunked prefill into contiguous rows: a 7- and a 3-token prompt in
    chunks of 4, the ragged lanes at the drop sentinel, then one decode
    step at the per-row lengths."""
    from repro_torch.serve.engine import _DROP_POS
    jm, jp, tm, tp = models
    jc = jm.init_cache(2, 12)
    tc = tm.init_cache(2, 12, "cpu")
    prompts = [_tokens(6, 1, 7)[0], _tokens(7, 1, 3)[0]]
    jchunk = jax.jit(jm.prefill_chunk)
    last = []
    for start in (0, 4):
        tok = np.zeros((2, 4), np.int32)
        qpos = np.tile(np.arange(start, start + 4, dtype=np.int32), (2, 1))
        wpos = np.full((2, 4), _DROP_POS, np.int32)
        for b, pr in enumerate(prompts):
            v = max(0, min(4, pr.size - start))
            tok[b, :v] = pr[start:start + v]
            wpos[b, :v] = qpos[b, :v]
        jl, jc = jchunk(jp, jc, *map(jnp.asarray, (tok, qpos, wpos)))
        tl, tc = tm.prefill_chunk(tp, tc, *map(torch.from_numpy,
                                               (tok, qpos, wpos)))
        _close(tl, jl)
        last.append(tl)
    lens = np.array([7, 3], np.int32)
    jc["len"], tc["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    nxt = np.array([int(last[1][0, 2].argmax()), int(last[0][1, 2].argmax())],
                   np.int32)
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
    _close(tl, jl)
    _cache_close(tc, jc)
