"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same numpy-seeded inputs, float32.

``capacity``; ``route`` (dispatch exactly, combine and aux within TOL);
``route_indices`` (every index exactly, gates within TOL); the einsum and
gather dispatches against JAX and against each other within TOL. Cases:
E 4 / k 2, E 16 / k 2 and E 64 / k 8 at d 128, with drops (capacity
factor 1.25) and without (a capacity that holds every choice), and with
forced ties (equal router columns, and tokens of zeros whose experts all
tie): ``jax.lax.top_k`` puts the lower index first, and so must the
port. Every case is seeded; nothing is drawn at random per run.

Weights here are drawn at std 1/sqrt(fan-in) so outputs are of order 1
and TOL is an absolute float32 bound (the models' tests carry the
reference's own init)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.models import moe

TOL = 1e-5
D, S, B = 128, 24, 2
CASES = [(4, 2), (16, 2), (64, 8)]


def _x(seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    if ties:
        x[:, ::3] = 0.0          # these tokens see every expert tied
    return x


def _router(seed, e, ties=False):
    r = (np.random.default_rng(seed + 1).standard_normal((D, e))
         / np.sqrt(D)).astype(np.float32)
    if ties:
        r[:, 1] = r[:, 0]        # experts 0 and 1, 2 and 3 always tie
        r[:, 3] = r[:, 2]
    return r


def _cap(e, k, drops):
    return (moe.capacity(S, e, k, 1.25) if drops else S * k)


def _cfgs(e, k, cf=1.25, act="swiglu"):
    """(JAX config, port config): reduced olmoe with this routing."""
    out = []
    for get, mcls in ((jget_arch, None), (get_arch, None)):
        c = get("olmoe-1b-7b").reduced()
        c = dataclasses.replace(
            c, d_model=D, d_ff=64, activation=act,
            moe=dataclasses.replace(c.moe, num_experts=e, top_k=k,
                                    capacity_factor=cf))
        out.append(c)
    return out


def _params(seed, e, act="swiglu"):
    rng = np.random.default_rng(seed + 2)
    f = 64
    p = {"router": _router(seed, e),
         "down": (rng.standard_normal((e, f, D)) / np.sqrt(f)).astype(
             np.float32)}
    names = ("gate", "up") if act == "swiglu" else ("in",)
    for n in names:
        p[n] = (rng.standard_normal((e, D, f)) / np.sqrt(D)).astype(
            np.float32)
    return p


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seq,e,k,cf", [
    (1, 64, 8, 1.25), (24, 4, 2, 1.25), (24, 64, 8, 1.25), (64, 64, 8, 1.25),
    (64, 16, 2, 1.25), (7, 16, 2, 1.0), (100, 4, 2, 8.0), (3, 64, 8, 0.1)])
def test_capacity_matches_reference(seq, e, k, cf):
    assert moe.capacity(seq, e, k, cf) == jmoe.capacity(seq, e, k, cf)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("e,k", CASES)
def test_route_matches_reference(e, k, drops, ties):
    x, r = _x(e + k, ties), _router(e + k, e, ties)
    cap = _cap(e, k, drops)
    jd, jc, ja = jmoe.route(_j(x), _j(r), e, k, cap)
    td, tc, ta = moe.route(_t(x), _t(r), e, k, cap)
    assert td.shape == (B, S, e, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), atol=TOL,
                                   rtol=0)
    frac = float(ta["moe_drop_frac"])
    assert (frac > 0) if drops and e < 64 else True
    assert frac == 0.0 or drops


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("e,k", CASES)
def test_route_indices_match_reference(e, k, drops, ties):
    x, r = _x(e * k, ties), _router(e * k, e, ties)
    cap = _cap(e, k, drops)
    want = jmoe.route_indices(_j(x), _j(r), e, k, cap)
    got = moe.route_indices(_t(x), _t(r), e, k, cap)
    for i, name in enumerate(("token_for_slot", "gate_for_slot",
                              "slot_for_token", "expert_for_token",
                              "kept_gates")):
        w, g = np.asarray(want[i]), got[i].numpy()
        assert g.shape == w.shape, name
        if w.dtype.kind in "iu":
            assert g.dtype == np.int32 and np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0,
                                       err_msg=name)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(got[5][key]), float(want[5][key]),
                                   atol=TOL, rtol=0)


def test_ties_route_to_the_lower_expert():
    """A token of zeros sees every expert at one probability: its k
    choices are experts 0..k-1, in order, as jax.lax.top_k picks them."""
    x = np.zeros((1, 3, D), np.float32)
    r = _router(0, 16)
    got = moe.route_indices(_t(x), _t(r), 16, 4, 12)
    assert got[3].tolist() == [[[0, 1, 2, 3]] * 3]


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("e,k", CASES)
def test_dispatches_match_reference_and_each_other(e, k, cf, ties, act):
    jcfg, tcfg = _cfgs(e, k, cf, act)
    p = _params(e + k, e, act)
    if ties:
        p["router"] = _router(e + k, e, ties=True)
    x = _x(3 * e + k, ties)
    jp = {n: _j(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    j_ein, ja = jmoe.moe_ffn_einsum(jp, _j(x), jcfg)
    j_gat, _ = jmoe.moe_ffn_gather(jp, _j(x), jcfg)
    t_ein, ta = moe.moe_ffn_einsum(tp, _t(x), tcfg)
    t_gat, tg = moe.moe_ffn_gather(tp, _t(x), tcfg)
    for got, want in ((t_ein, j_ein), (t_gat, j_gat), (t_gat, t_ein)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), atol=TOL,
                                   rtol=0)
        assert float(tg[key]) == pytest.approx(float(ta[key]), abs=TOL)


def test_moe_ffn_selects_the_dispatch_as_the_reference(monkeypatch):
    _, tcfg = _cfgs(16, 2)
    tp = {n: _t(a) for n, a in _params(5, 16).items()}
    x = _t(_x(5))
    ein, gat = (moe.moe_ffn_einsum(tp, x, tcfg)[0],
                moe.moe_ffn_gather(tp, x, tcfg)[0])
    monkeypatch.delenv("REPRO_MOE_GATHER_DISPATCH", raising=False)
    assert torch.equal(moe.moe_ffn(tp, x, tcfg)[0], ein)
    monkeypatch.setenv("REPRO_MOE_GATHER_DISPATCH", "1")
    assert torch.equal(moe.moe_ffn(tp, x, tcfg)[0], gat)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_decode_token_drops_nothing(name):
    """One token a row (decode) at the published routing: k * cf <= E, so
    every choice has a slot of its own."""
    cfg = get_arch(name)
    mo = cfg.moe
    e, k = mo.num_experts, mo.top_k
    cap = moe.capacity(1, e, k, mo.capacity_factor)
    x = _t(np.random.default_rng(7).standard_normal((4, 1, D)).astype(
        np.float32))
    r = _t(_router(7, e))
    _, _, aux = moe.route(x, r, e, k, cap)
    assert float(aux["moe_drop_frac"]) == 0.0


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_spec_router_is_float32_whatever_the_dtype(name):
    """moe_spec against the reference's: same leaves and shapes, the
    router in float32 and the experts in the parameter dtype (bf16)."""
    cfg, jcfg = get_arch(name), jget_arch(name)
    t = moe.moe_spec(cfg, cfg.dtype)
    j = jmoe.moe_spec(jcfg, jcfg.dtype)
    assert {n: s.shape for n, s in t.items()} == {n: s.shape
                                                  for n, s in j.items()}
    assert t["router"].dtype == torch.float32
    assert all(s.dtype == torch.bfloat16 for n, s in t.items()
               if n != "router")
