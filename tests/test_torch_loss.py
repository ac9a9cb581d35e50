"""The training loss and its gradients against the JAX package: the
port's ``loss_fn`` differentiated by autograd against
``jax.value_and_grad`` of the reference's, on every one of the ten
architectures reduced (float32, the reference's weights through the
bridge, numpy-seeded batches): the dense and MoE decoders (the MoE aux
loss added at 0.01), gemma3's leftover layers, pure mamba and the hybrid
under both inner scans, the encoder-decoder and the stub frontend. Then
rematerialization: the port's gradients with ``remat`` on equal those
with it off exactly, flat and two-level (16 periods: the reference's
``test_two_level_remat_matches_flat``), and ``loss_fn`` draws nothing
from a generator.

Tolerances: the loss and the metrics within 1e-5 x max(1, |ref|), each
gradient leaf within 1e-4 x max(1, max |ref leaf|) — or, where larger,
the model's measured float32 conditioning: how far the reference's own
loss and gradients move (the gradients relative to each leaf's largest
|value|, the worst leaf) when its input moves by one float32 ulp
(``_ulp_spread``: the token embedding of a token model, the frames or
embeddings of the others). The reference's fan-in quirk draws stacked
weights at std 1/sqrt(n_periods): reduced jamba (one period) moves its
gradients by ~0.34 there and its loss by more than 1e-5, whisper (two
encoder layers whose attention scores reach ~1e3) its gradients by
~3e-3, minitron by ~1.1e-4; the others stay inside 1e-4 (my CPU
run)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.train.train_loop import value_and_grad

LOSS_TOL = 1e-5
TOL = 1e-4
ARCHS = sorted(J_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny reduced models gain nothing from intra-op threads, and the
    suite's workers share the CPU: one thread each keeps this module's
    runs from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(name, layers=None):
    jc, tc = jget_arch(name).reduced(), get_arch(name).reduced()
    if layers:
        jc = dataclasses.replace(jc, num_layers=layers)
        tc = dataclasses.replace(tc, num_layers=layers)
    jm, tm = jbuild(jc), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def batch_for(cfg, seed=1):
    """numpy batch of the family's layout: next-token pairs from one
    sequence for a token model; frames, decoder tokens and labels for
    the encoder-decoder; embeddings and labels for the stub frontend."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"embeds": rng.standard_normal((2, 12, cfg.d_model)).astype(
                    np.float32),
                "tokens": rng.integers(0, 512, (2, 16)).astype(np.int32),
                "labels": rng.integers(0, 512, (2, 16)).astype(np.int32)}
    if cfg.frontend is not None:
        return {"embeds": rng.standard_normal((2, 16, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, 512, (2, 16)).astype(np.int32)}
    seq = rng.integers(0, 512, (2, 17)).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:].copy()}


@functools.lru_cache(maxsize=None)
def _jgrad(jm):
    """The reference's jitted ``value_and_grad`` of its loss (one compile
    per model; a test that changes how the reference traces builds its
    own)."""
    return jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))


def _paths(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ulp_spread(name):
    """How far the reference's own loss and gradients move when the
    model's input moves by one float32 ulp (one seeded sign per entry):
    (the loss's relative movement, the worst leaf's gradient movement
    relative to that leaf's largest |value|)."""
    jm, jp, _, _ = models(name)
    b = batch_for(jm.cfg)
    vg = _jgrad(jm)
    (loss0, _), g0 = vg(jp, {k: jnp.asarray(v) for k, v in b.items()})

    def move(a):
        s = np.random.default_rng(7).choice([-1.0, 1.0], a.shape)
        return np.nextafter(a, (s * np.inf).astype(np.float32))

    if "embeds" in b:
        b = dict(b, embeds=move(b["embeds"]))
        jp2 = jp
    else:
        jp2 = dict(jp, embed={"tokens": jnp.asarray(
            move(np.asarray(jp["embed"]["tokens"])))})
    (loss1, _), g1 = vg(jp2, {k: jnp.asarray(v) for k, v in b.items()})
    base, moved = _paths(g0), _paths(g1)
    return (abs(float(loss1) - float(loss0)) / max(1.0, abs(float(loss0))),
            max(float(np.abs(moved[k] - base[k]).max()
                      / max(1.0, float(np.abs(base[k]).max())))
                for k in base))


def tols(name):
    """(loss tolerance, gradient tolerance), relative: LOSS_TOL and TOL,
    or the reference's measured one-ulp movement where larger."""
    loss_rel, grad_rel = _ulp_spread(name)
    return max(LOSS_TOL, loss_rel), max(TOL, grad_rel)


def _check(name, jm, jp, tm, tp, b, jgrad=None):
    jgrad = jgrad or _jgrad(jm)
    (jl, jmet), jg = jgrad(jp, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tmet), tg = value_and_grad(
        tm.loss_fn, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    loss_tol, rel = tols(name)
    assert abs(float(tl) - float(jl)) <= loss_tol * max(1.0, abs(float(jl)))
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        assert abs(float(tmet[k]) - float(jmet[k])) <= loss_tol * max(
            1.0, abs(float(jmet[k]))), k
    want, got = _paths(jg), dict(tree_leaves(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        tol = rel * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].numpy(), w, atol=tol, rtol=0,
                                   err_msg=path)
    return tg


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    """Loss, metrics and every gradient leaf, remat off."""
    jm, jp, tm, tp = models(name)
    tm.remat = False
    _check(name, jm, jp, tm, tp, batch_for(tm.cfg))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_leftover_layers_loss_and_grads_match_reference(remat):
    """gemma3-1b at 8 layers: one period of 6 and two leftover layers,
    which the remat leaves unrecomputed, as the reference's scan does."""
    jm, jp, tm, tp = models("gemma3-1b", layers=8)
    assert tm.leftover and tm.n_periods == 1
    tm.remat = remat
    try:
        _check("gemma3-1b", jm, jp, tm, tp, batch_for(tm.cfg))
    finally:
        tm.remat = False


@pytest.mark.parametrize("inner", ["associative"])
@pytest.mark.parametrize("name", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_recurrent_loss_grads_under_both_inner_scans(name, inner,
                                                     monkeypatch):
    """The other mamba prefill scan of both packages, selected by
    ``REPRO_MAMBA_INNER`` (read at call time by both); the default,
    sequential, is test_loss_and_grads_match_reference's."""
    monkeypatch.setenv("REPRO_MAMBA_INNER", inner)
    jm, jp, tm, tp = models(name)
    tm.remat = False
    _check(name, jm, jp, tm, tp, batch_for(tm.cfg),
           jgrad=jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True)))


def test_masked_loss_matches_reference():
    """The optional ``mask``: the mean over the kept positions only."""
    jm, jp, tm, tp = models("qwen3-14b")
    b = batch_for(tm.cfg)
    b["mask"] = (np.random.default_rng(4).random((2, 16)) < 0.6).astype(
        np.float32)
    tm.remat = False
    _check("qwen3-14b", jm, jp, tm, tp, b)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gradients_equal_plain(name):
    """Recomputation reproduces the forward exactly: gradients and loss
    with remat on equal those with it off, bit for bit."""
    _, _, tm, tp = models(name)
    b = {k: torch.from_numpy(v) for k, v in batch_for(tm.cfg).items()}
    tm.remat = False
    (l0, _), g0 = value_and_grad(tm.loss_fn, tp, b)
    tm.remat = True
    try:
        (l1, _), g1 = value_and_grad(tm.loss_fn, tp, b)
    finally:
        tm.remat = False
    assert torch.equal(l0, l1)
    for (p, a), (_, c) in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c), p


def test_two_level_remat_matches_flat(monkeypatch):
    """16 periods of reduced qwen3-14b: the sqrt-N grouping (4 groups of
    4) gives the flat per-period remat's gradients, as in the
    reference's test of the same name; both equal the reference's."""
    jm, jp, tm, tp = models("qwen3-14b", layers=16)
    b = {k: torch.from_numpy(v)
         for k, v in batch_for(tm.cfg, seed=5).items()}
    tm.remat = True
    try:
        assert tm._remat_group() == 4
        (l2, _), g2 = value_and_grad(tm.loss_fn, tp, b)
        monkeypatch.setenv("REPRO_FLAT_REMAT", "1")
        assert tm._remat_group() == 1
        (l1, _), g1 = value_and_grad(tm.loss_fn, tp, b)
    finally:
        tm.remat = False
    assert torch.equal(l1, l2)
    for (p, a), (_, c) in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, c), p
    want = _paths(_jgrad(jm)(jp, {k: jnp.asarray(v.numpy())
                                  for k, v in b.items()})[1])
    for p, g in tree_leaves(g2):
        np.testing.assert_allclose(g.numpy(), want[p], atol=1e-5, rtol=1e-4,
                                   err_msg=p)


def test_loss_draws_no_generator():
    """Remat recomputes the forward, so nothing in ``loss_fn`` may draw
    random numbers: the default generator's state is unchanged."""
    _, _, tm, tp = models("olmoe-1b-7b")
    b = {k: torch.from_numpy(v) for k, v in batch_for(tm.cfg).items()}
    before = torch.random.get_rng_state()
    tm.remat = True
    try:
        value_and_grad(tm.loss_fn, tp, b)
    finally:
        tm.remat = False
    assert torch.equal(torch.random.get_rng_state(), before)
    assert os.environ.get("REPRO_FLAT_REMAT") is None
