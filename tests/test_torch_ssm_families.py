"""The recurrent decoders of the JAX package through the port's model
paths, reduced, float32: ``falcon-mamba-7b`` (pure mamba), ``jamba-1.5-
large-398b`` at its reduced 8 layers (one period: attention + 7 mamba,
MoE on every other layer) and jamba at 4 layers (no whole period: four
leftover layers). Weights are the JAX ``LM.init``'s, carried over by
``models.bridge``.

Against the JAX ``LM`` on the same numpy-seeded tokens: the configs'
helpers and full-width parameter counts, ``forward`` logits and the MoE
aux, exact-length ``prefill`` (logits, every k/v and conv/h leaf, the
length), the contiguous ``decode_step`` after it, and the paged
``decode_step`` (gather and fused-plain reads) from an empty arena with
the mamba state slot-dense beside it; and ``block_prefill_chunk`` /
``prefill_chunk`` refusing a mamba layer in both packages.

TOL is 1e-4 relative to the reference's largest |value|, as in
tests/test_torch_families.py. Reduced jamba at 8 layers is one stacked
period: the reference's init draws each stacked weight at std
1/sqrt(n_periods) = 1, which drives its residual stream to ~1e12, and
the model is so ill-conditioned there that moving its embedding by one
float32 ulp moves the reference's own logits by ~1e-2 of their range.
No float32 implementation that does not reproduce XLA's rounding can
meet 1e-4 there. For it every block is held at TOL on the reference's
own input to that block, and the whole model at the reference's own
one-ulp movement (``_ulp_spread``), measured in the test.

The reference builds a zero-period cache without its stacked axis (its
``init_cache`` drops ``stack_n`` when it is 0), which no reference
engine can insert into; :class:`ZeroPeriodLM` keeps the empty axis, as
the reference's prefill emits it, so its engines can serve jamba at 4
layers (tests/test_torch_ssm_engine.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import blocks as jblocks
from repro.models.common import count_params as jcount
from repro.models.lm import LM as JLM
from repro_torch.configs import get_arch
from repro_torch.models import blocks, build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import count_params, tree_leaves

TOL = 1e-4
SSM = ["falcon-mamba-7b", "jamba-1.5-large-398b",
       "jamba-1.5-large-398b-4"]
FULL_COUNTS = {"falcon-mamba-7b": (6.5e9, 7.7e9),
               "jamba-1.5-large-398b": (380e9, 410e9)}


class ZeroPeriodLM(JLM):
    """The reference LM whose ``init_cache`` keeps a leading axis of 0
    when the model has no whole period (its prefill's cache has one)."""

    def init_cache(self, batch_size, max_len, for_shapes=False):
        cache = super().init_cache(batch_size, max_len, for_shapes)
        if self.n_periods == 0:
            if for_shapes:
                def grow(a):
                    return jax.ShapeDtypeStruct((0,) + a.shape, a.dtype)
            else:
                def grow(a):
                    return jnp.zeros((0,) + a.shape, a.dtype)
            cache["periods"] = jax.tree_util.tree_map(grow, cache["periods"])
        return cache


def configs(name):
    """(JAX config, port config), reduced; ``-4``: jamba at 4 layers."""
    base = name.removesuffix("-4")
    jc, tc = jget_arch(base).reduced(), get_arch(base).reduced()
    if name.endswith("-4"):
        jc = dataclasses.replace(jc, num_layers=4)
        tc = dataclasses.replace(tc, num_layers=4)
    return jc, tc


@functools.lru_cache(maxsize=None)
def models(name):
    jc, tc = configs(name)
    jm, tm = ZeroPeriodLM(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def _jit(jm, fn):
    """The reference LM's ``fn`` under ``jax.jit`` (its op-by-op form is
    several times slower on these shapes)."""
    static = {"prefill": ("max_len",), "decode_step": ("attn_impl",)}
    return jax.jit(getattr(jm, fn), static_argnames=static.get(fn, ()))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _ulp_spread(name):
    """How far the reference's own logits move, relative to their largest
    |value|, when every embedding entry moves by one float32 ulp (one
    seeded sign per entry) — the model's float32 conditioning."""
    jm, jp, _, _ = models(name)
    tok = jnp.asarray(_tokens(1, 2, 20))
    base = np.asarray(_jit(jm, "forward")(jp, {"tokens": tok})[0])
    emb = np.asarray(jp["embed"]["tokens"])
    sign = np.random.default_rng(0).choice([-1.0, 1.0], emb.shape)
    moved = np.nextafter(emb, (sign * np.inf).astype(np.float32))
    jp2 = dict(jp, embed={"tokens": jnp.asarray(moved)})
    other = np.asarray(_jit(jm, "forward")(jp2, {"tokens": tok})[0])
    return float(np.abs(other - base).max() / np.abs(base).max())


def _rel_tol(name):
    """TOL, or for the ill-conditioned reduced jamba of one stacked
    period its measured one-ulp spread (never below TOL)."""
    if name == "jamba-1.5-large-398b":
        return max(TOL, _ulp_spread(name))
    return TOL


def close(got, want, what="", rel=TOL):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=what)


def _leaves(tree):
    return {p: leaf for p, leaf in tree_leaves(
        {k: tree[k] for k in ("periods", "leftover")})}


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_full_width_config_and_parameter_count(name):
    """The published model: the helpers as the reference's, and the
    parameter count equal to the reference's and inside the reference's
    own range (tests/test_models_smoke.py)."""
    from repro.models import build_model as jbuild
    j, t = jget_arch(name), get_arch(name)
    assert (t.attention_free, t.subquadratic, t.layer_kinds()) == (
        j.attention_free, j.subquadratic, j.layer_kinds())
    assert ([t.moe_on_layer(i) for i in range(t.num_layers)]
            == [j.moe_on_layer(i) for i in range(j.num_layers)])
    n = count_params(build_model(t).spec_tree())
    assert n == jcount(jbuild(j).spec_tree())
    lo, hi = FULL_COUNTS[name]
    assert lo <= n <= hi, n
    assert t.attention_free == (name == "falcon-mamba-7b")


@pytest.mark.parametrize("name", SSM)
def test_forward_logits_and_aux_match_reference(name):
    jm, jp, tm, tp = models(name)
    tok = _tokens(1, 2, 20)
    jl, ja = _jit(jm, "forward")(jp, {"tokens": jnp.asarray(tok)})
    tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    close(tl.numpy(), jl, rel=_rel_tol(name))
    assert sorted(ta) == sorted(ja)
    assert bool(ta) == (tm.cfg.moe is not None)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_jamba_blocks_match_reference_on_its_inputs():
    """Reduced jamba's 8 layers one at a time, each fed the reference's
    output of the layer before: every block's output within TOL."""
    jm, jp, tm, tp = models("jamba-1.5-large-398b")
    tok = _tokens(1, 2, 20)
    x = np.asarray(jm._embed_in(jp, {"tokens": jnp.asarray(tok)}))
    pos = np.broadcast_to(np.arange(20)[None], (2, 20)).astype(np.int32)
    for j, (kind, use_moe) in enumerate(jm.layout):
        name = f"layer_{j}"
        jpl = jax.tree_util.tree_map(lambda a: a[0], jp["periods"][name])
        tpl = {k: v for k, v in _index(tp["periods"][name]).items()}
        want, _, _ = jblocks.block_forward(jpl, jnp.asarray(x), jm.cfg,
                                           kind, use_moe, jnp.asarray(pos))
        got, _, _ = blocks.block_forward(tpl, torch.from_numpy(x.copy()),
                                         tm.cfg, kind, use_moe,
                                         torch.from_numpy(pos.copy()))
        close(got.numpy(), want, name)
        x = np.asarray(want)


def _index(tree):
    return {k: _index(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _prefill(name):
    jm, jp, tm, tp = models(name)
    tok = _tokens(2, 2, 13)
    jl, jc = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(tok)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)})
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("name", SSM)
def test_prefill_matches_reference(name):
    """Exact-length prefill (the only form a recurrent model takes):
    logits, every k/v and conv/h leaf, the scalar length."""
    (jl, jc), (tl, tc) = _prefill(name)
    rel = _rel_tol(name)
    close(tl.numpy(), jl, "logits", rel=rel)
    want = _leaves(jax.tree_util.tree_map(np.asarray, jc))
    got = _leaves(tc)
    assert sorted(got) == sorted(want)
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        close(got[path].numpy(), want[path], path, rel=rel)
    assert any(p.endswith("/h") for p in got)
    assert int(tc["len"]) == int(jc["len"]) == 13


@pytest.mark.parametrize("name", SSM)
def test_contiguous_decode_matches_reference(name):
    """Three greedy steps on the prefilled cache (k/v padded to 16, the
    state stepped in place)."""
    jm, jp, tm, tp = models(name)
    tok = _tokens(2, 2, 13)
    jl, jc = _jit(jm, "prefill")(jp, {"tokens": jnp.asarray(tok)}, max_len=16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, max_len=16)
    rel = _rel_tol(name)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jc = _jit(jm, "decode_step")(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        close(tl.numpy(), jl, rel=rel)
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    want = _leaves(jax.tree_util.tree_map(np.asarray, jc))
    for path, leaf in _leaves(tc).items():
        close(leaf.numpy(), want[path], path, rel=rel)
    assert int(tc["len"]) == 16


def _paged_caches(jm, tm, pages, ps, num_pages, rows):
    """Empty paged caches: k/v arenas of ``num_pages`` pages, the mamba
    state one row per sequence (``rows``), in both packages."""
    arena = jm.init_cache(num_pages, ps)
    dense = jm.init_cache(rows, ps)
    jc = {g: {layer: {n: (arena if n in ("k", "v") else dense)[g][layer][n]
                      for n in entry}
              for layer, entry in arena[g].items()}
          for g in ("periods", "leftover")}
    jc["len"] = jnp.zeros((rows,), jnp.int32)
    jc["pages"] = jnp.asarray(pages)
    tc = tm.init_cache(num_pages, ps, "cpu", state_batch=rows)
    tc["len"] = torch.zeros(rows, dtype=torch.int32)
    tc["pages"] = torch.from_numpy(pages)
    return jc, tc


@pytest.mark.parametrize("impl", ["gather", "fused"])
@pytest.mark.parametrize("name", SSM)
def test_paged_decode_matches_reference(name, impl):
    """Six teacher-forced steps from an empty paged arena (page size 4,
    scattered tables, one sentinel entry) beside the slot-dense state:
    logits within tolerance at every step, every arena and state leaf
    after."""
    jm, jp, tm, tp = models(name)
    ps, num_pages = 4, 8
    pages = np.array([[3, 1, 8], [0, 5, 8]], np.int32)
    jc, tc = _paged_caches(jm, tm, pages, ps, num_pages, 2)
    rel = _rel_tol(name)
    for tok in _tokens(3, 6, 2):
        jl, jc = _jit(jm, "decode_step")(jp, jc, jnp.asarray(tok), attn_impl=impl)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                attn_impl=impl)
        close(tl.numpy(), jl, rel=rel)
    want = _leaves(jax.tree_util.tree_map(np.asarray, jc))
    for path, leaf in _leaves(tc).items():
        close(leaf.numpy(), want[path], path, rel=rel)
    assert tc["len"].tolist() == [6, 6]


@pytest.mark.parametrize("name", SSM)
def test_chunked_prefill_refuses_mamba(name):
    jm, jp, tm, tp = models(name)
    kind, use_moe = "mamba", False
    j = [k for k, _ in tm.layout].index("mamba")
    p = (_index(tp["periods"][f"layer_{j}"]) if tm.n_periods
         else tp["leftover"][f"layer_{j}"])
    x = torch.zeros(1, 4, tm.cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="mamba prefill is recurrent"):
        blocks.block_prefill_chunk(p, x, {}, tm.cfg, kind, use_moe, pos,
                                   pos)
    with pytest.raises(ValueError, match="mamba prefill is recurrent"):
        jblocks.block_prefill_chunk({}, jnp.zeros((1, 4, 8)), {}, jm.cfg,
                                    kind, use_moe, jnp.asarray(pos.numpy()),
                                    jnp.asarray(pos.numpy()))
    tc = tm.init_cache(2, 8, "cpu")
    with pytest.raises(ValueError, match="mamba prefill is recurrent"):
        tm.prefill_chunk(tp, tc, torch.zeros(2, 4, dtype=torch.int32),
                         pos.expand(2, 4), pos.expand(2, 4))
