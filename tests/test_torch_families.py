"""The other attention-only decoders of the JAX package through the port's
model paths, reduced, float32: ``olmoe-1b-7b`` and
``phi3.5-moe-42b-a6.6b`` (MoE), ``gemma3-1b`` (five local layers with a
window to one global, scaled embeddings, GeGLU), gemma3-1b with two
leftover layers after its period (8 layers), ``minitron-4b`` (squared
ReLU, untied) and ``qwen1.5-110b`` (qkv bias, untied). Weights are the
JAX ``LM.init``'s, carried over by ``models.bridge``.

Against the JAX ``LM`` on the same numpy-seeded tokens: ``forward``
logits and the MoE aux, one-shot ``prefill`` with per-row lengths
(logits and every cache leaf), the contiguous ``decode_step``, and
chunked ``prefill_chunk`` then ``decode_step`` on the paged arena
(gather and fused-plain reads) with greedy tokens identical and every
arena leaf close after. gemma3's prompts pass its reduced window of 8.
And, in the port alone, prefill + decode equals forward, as the
reference's ``test_prefill_decode_matches_forward`` holds.

TOL is 1e-4 relative to the reference's largest |value| (at least 1e-4
absolute). The reference's init draws every period-stacked weight at
std 1/sqrt(n_periods) (fan-in taken from the stacked axis, a quirk both
packages keep), which drives the residual stream of these reduced
models to ~2e3: float32 rounding there alone is ~2e-4, and the
families without qk-norm carry it to logits of ~4. Scaled, TOL stays
far stricter than the reference's own 2e-2 for prefill + decode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.serve.engine import _DROP_POS

TOL = 1e-4
FAMILIES = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "gemma3-1b",
            "gemma3-1b-leftover", "minitron-4b", "qwen1.5-110b"]


def configs(name):
    """(JAX config, port config) of a family, reduced; ``-leftover``:
    gemma3-1b at 8 layers (one period of 6 and 2 leftover layers)."""
    base = name.removesuffix("-leftover")
    jc, tc = jget_arch(base).reduced(), get_arch(base).reduced()
    if name.endswith("-leftover"):
        jc = dataclasses.replace(jc, num_layers=8)
        tc = dataclasses.replace(tc, num_layers=8)
    return jc, tc


@functools.lru_cache(maxsize=None)
def models(name):
    jc, tc = configs(name)
    jm, tm = jbuild(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def close(got, want, what=""):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=what)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _cache_leaves(tree):
    return {p: leaf for p, leaf in tree_leaves(
        {k: tree[k] for k in ("periods", "leftover")})}


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_and_aux_match_reference(name):
    jm, jp, tm, tp = models(name)
    tok = _tokens(1, 2, 20)
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(tok)})
    tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    close(tl.numpy(), jl)
    assert sorted(ta) == sorted(ja)
    assert bool(ta) == (tm.cfg.moe is not None)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def _prefill(name, max_len=24):
    jm, jp, tm, tp = models(name)
    tok = _tokens(2, 2, 16)
    length = np.array([16, 11], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=max_len,
                        length=jnp.asarray(length))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)},
                        max_len=max_len, length=torch.from_numpy(length))
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(name):
    (jl, jc), (tl, tc) = _prefill(name)
    close(tl.numpy(), jl, "logits")
    want = _cache_leaves(jax.tree_util.tree_map(np.asarray, jc))
    got = _cache_leaves(tc)
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path].numpy(), want[path], path)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("name", FAMILIES)
def test_contiguous_decode_matches_reference(name):
    """Three greedy steps on the prefilled contiguous cache, per-row
    lengths 16 and 11."""
    jm, jp, tm, tp = models(name)
    (jl, jc), (tl, tc) = _prefill(name)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(dim=-1).numpy(), tok)
    assert tc["len"].tolist() == [19, 14]


@pytest.mark.parametrize("impl", ["gather", "fused"])
@pytest.mark.parametrize("name", FAMILIES)
def test_paged_chunks_then_decode_match_reference(name, impl):
    """Two rows prefill 13- and 10-token prompts in chunks of 4 (ragged
    lanes at the drop sentinel) on a paged arena of page size 4, then
    decode 4 greedy tokens each: logits within TOL at every call, tokens
    identical, every arena leaf close after."""
    jm, jp, tm, tp = models(name)
    ps, num_pages, c = 4, 16, 4
    pages = np.array([[3, 1, 4, 9, 12, 16], [0, 2, 5, 7, 16, 16]], np.int32)
    jc = jm.init_cache(num_pages, ps)
    jc["pages"] = jnp.asarray(pages)
    tc = tm.init_cache(num_pages, ps, "cpu")
    tc["pages"] = torch.from_numpy(pages)
    prompts = [_tokens(3, 1, 13)[0], _tokens(4, 1, 10)[0]]
    jchunk = jax.jit(jm.prefill_chunk)
    last = [None, None]           # each row's logits at its last prompt token
    for start in range(0, 13, c):
        tok = np.zeros((2, c), np.int32)
        qpos = np.tile(np.arange(start, start + c, dtype=np.int32), (2, 1))
        wpos = np.full((2, c), _DROP_POS, np.int32)
        n_live = [max(0, min(c, pr.size - start)) for pr in prompts]
        for b, (pr, v) in enumerate(zip(prompts, n_live)):
            tok[b, :v] = pr[start:start + v]
            wpos[b, :v] = qpos[b, :v]
        jl, jc = jchunk(jp, jc, *map(jnp.asarray, (tok, qpos, wpos)))
        tl, tc = tm.prefill_chunk(tp, tc, *map(torch.from_numpy,
                                               (tok, qpos, wpos)))
        close(tl.numpy(), jl, f"chunk at {start}")
        for b, v in enumerate(n_live):
            if v:
                last[b] = np.asarray(jl)[b, v - 1]
    tok = np.array([int(np.argmax(x)) for x in last], np.int32)
    jc["len"] = jnp.asarray([13, 10], dtype=jnp.int32)
    tc["len"] = torch.tensor([13, 10], dtype=torch.int32)
    jdec = jax.jit(jm.decode_step, static_argnames=("attn_impl",))
    for _ in range(4):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), attn_impl=impl)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                attn_impl=impl)
        close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(dim=-1).numpy(), tok)
    assert tc["len"].tolist() == [17, 14]
    want = _cache_leaves(jax.tree_util.tree_map(np.asarray, jc))
    got = _cache_leaves(tc)
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path].numpy(), want[path], path)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_forward(name):
    """prefill(seq[:16]) + decode(seq[16:24]) equals forward(seq) at the
    last position, in the port. An MoE layer's capacity is per row over
    the tokens of one call, so a forward over 24 tokens may drop choices
    that decode (one token) keeps: the MoE families run here at a
    capacity factor of E, where no call drops anything (the weights do
    not change)."""
    _, _, tm, tp = models(name)
    if tm.cfg.moe is not None:
        mo = tm.cfg.moe
        tm = build_model(dataclasses.replace(tm.cfg, moe=dataclasses.replace(
            mo, capacity_factor=float(mo.num_experts))))
    tok = torch.from_numpy(_tokens(5, 2, 24))
    full, _ = tm.forward(tp, {"tokens": tok})
    _, cache = tm.prefill(tp, {"tokens": tok[:, :16]}, max_len=24)
    for i in range(16, 24):
        logits, cache = tm.decode_step(tp, cache, tok[:, i])
    close(logits.numpy(), full[:, -1].numpy())
