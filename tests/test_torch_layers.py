"""PyTorch port vs the JAX reference: norms, RoPE, embeddings, FFN.

Same float32 inputs, made from a seed with numpy, through
``repro.models.layers`` and ``repro_torch.models.layers``; every case
must agree within TOL (max abs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import layers as jl
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tl

TOL = 1e-5


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm(eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    (xj, xt), (sj, st) = _pair(x), _pair(scale)
    _close(jl.rmsnorm({"scale": sj}, xj, eps),
           tl.rmsnorm({"scale": st}, xt, eps))


def test_head_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    (xj, xt), (sj, st) = _pair(x), _pair(scale)
    _close(jl.head_rmsnorm({"scale": sj}, xj),
           tl.head_rmsnorm({"scale": st}, xt))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [8, 32])
def test_rope(theta, hd):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    (xj, xt), (pj, pt) = _pair(x), _pair(pos)
    _close(jl.rope(xj, pj, theta), tl.rope(xt, pt, theta))


def test_embed():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    (tj, tt), (ij, it) = _pair(table), _pair(ids)
    _close(jl.embed({"tokens": tj}, ij), tl.embed({"tokens": tt}, it))


@pytest.mark.parametrize("tie", [True, False])
def test_unembed(tie):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    (xj, xt), (ej, et), (hj, ht) = _pair(x), _pair(emb), _pair(head)
    got = tl.unembed({"tokens": et}, {"kernel": ht}, xt, tie=tie)
    assert got.dtype == torch.float32
    _close(jl.unembed({"tokens": ej}, {"kernel": hj}, xj, tie=tie), got)


def test_unembed_low_precision_blocks(monkeypatch):
    """A bf16 embedding is upcast a block of vocab rows at a time; the
    blocks (here 7 rows, so the last is ragged) must give the
    reference's whole-table float32 product."""
    monkeypatch.setattr(tl, "_UNEMBED_ROWS", 7)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    ej = jnp.asarray(emb, jnp.bfloat16)
    et = torch.from_numpy(emb).to(torch.bfloat16)
    xj, xt = _pair(x)
    _close(jl.unembed({"tokens": ej}, None, xj, tie=True),
           tl.unembed({"tokens": et}, None, xt, tie=True))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp(act):
    rng = np.random.default_rng(6)
    d, f = 16, 40
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    names = ("gate", "up", "down") if act == "swiglu" else ("in", "out")
    shapes = {"gate": (d, f), "up": (d, f), "down": (f, d), "in": (d, f),
              "out": (f, d)}
    w = {n: (rng.standard_normal(shapes[n]) / np.sqrt(shapes[n][0])
             ).astype(np.float32) for n in names}
    pj = {n: jnp.asarray(a) for n, a in w.items()}
    pt = {n: torch.from_numpy(a) for n, a in w.items()}
    xj, xt = _pair(x)
    _close(jl.mlp(pj, xj, act), tl.mlp(pt, xt, act))


@pytest.mark.parametrize("name", ["swiglu", "silu", "gelu", "relu2"])
def test_activation(name):
    x = np.linspace(-4, 4, 33).astype(np.float32)
    xj, xt = _pair(x)
    _close(jcommon.activation(name)(xj), tcommon.activation(name)(xt))


def test_init_params_rules():
    """Zeros/ones leaves are constant; normal leaves have std
    init_scale / sqrt(fan_in) with fan_in the leading dimension (the
    last one for vectors) — the reference's rules, drawn from an
    explicit generator."""
    spec = {"w": tcommon.spec((400, 300), torch.float32),
            "v": tcommon.spec((900,), torch.float32, scale=2.0),
            "z": tcommon.spec((3, 4), torch.float32, init="zeros"),
            "o": tcommon.spec((5,), torch.bfloat16, init="ones")}
    p = tcommon.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    assert float(p["w"].std()) == pytest.approx(1 / np.sqrt(400), rel=0.02)
    assert float(p["v"].std()) == pytest.approx(2 / np.sqrt(900), rel=0.06)
    assert bool((p["z"] == 0).all()) and bool((p["o"] == 1).all())
    assert p["o"].dtype == torch.bfloat16
    again = tcommon.init_params(spec, torch.Generator().manual_seed(0),
                                "cpu")
    assert torch.equal(p["w"], again["w"])
