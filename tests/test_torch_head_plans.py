"""The tensor-parallel head plans of the JAX package's attention through
the port, on the CPU, float32. Run as a script, it prints the largest
errors at these shapes (PERF.md's parity table):

    PYTHONPATH=src python tests/test_torch_head_plans.py

* ``head_plan`` equal to the reference's for 1-64 heads at tp 1, 2, 3,
  4, 8 and 16; ``expand_kv(pad_to=)``, ``pad_heads``,
  ``kv_chunked_attention`` (causal and not, several chunks) and
  ``banded_attention`` (windows 1, 5 and past S) against the
  reference's functions called with no policy, within 1e-5.
* The two repairs: ``attention_out`` masks the padded rows of ``wo``
  and the fused adapter drops padded query heads before the kernel and
  pads its output back with zeros (both raised before), each against
  the reference.
* At model level under the ``'pad'`` plan (tp 3 over 4 reduced heads:
  6 stored, ``activation_sharding(mesh, ())`` on both sides with the
  weights carried from the reference's padded tree): reduced qwen3-14b,
  minitron-4b and gemma3-1b ``forward``, ``prefill``, contiguous and
  paged ``decode_step`` (gather, and the fused adapter's plain version)
  and whisper-small's ``encode``, loss, ``prefill`` and decode steps, within
  1e-4 x max(1, max |ref|); the main-path engine's greedy streams and
  ``grant_log`` equal to the JAX engine's.
* The ``'seq'`` plan (tp 8 over gemma3's 4 heads: banded local layers,
  kv-chunked global ones) against the JAX package under a real (1, 8)
  host-device mesh in one subprocess, and against the port's own
  ``'shard'`` forward on the same weights.
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels.paged_attention.ops import (
    paged_decode_fused as jpaged_decode_fused)
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serve.engine import SlotServeEngine as JEngine
from repro.sharding.act import activation_sharding as jpolicy
from repro_torch.configs import get_arch
from repro_torch.kernels.paged_attention import paged_decode_fused
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve.engine import SlotServeEngine, _DROP_POS
from repro_torch.sharding.act import MeshShape, activation_sharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
PAD_ARCHS = ["qwen3-14b", "minitron-4b", "gemma3-1b"]


class FakeMesh:
    """The reference tests' duck-typed mesh (axis names + shape dict)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what="", tol=TOL):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=what)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ units
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8, 16])
def test_head_plan_equals_reference(tp):
    for h in range(1, 65):
        assert attn.head_plan(h, tp) == jattn.head_plan(h, tp), (h, tp)
    with activation_sharding(MeshShape({"data": 2, "model": tp}), ()):
        with jpolicy(FakeMesh({"data": 2, "model": tp}), ()):
            assert [attn.head_plan(h) for h in range(1, 65)] == [
                jattn.head_plan(h) for h in range(1, 65)]


def test_head_plan_production_cases():
    """The module docstring's cases at tp 16."""
    assert attn.head_plan(40, 16) == ("pad", 48)       # qwen3-14b
    assert attn.head_plan(24, 16) == ("pad", 32)       # minitron-4b
    assert attn.head_plan(12, 16) == ("pad", 16)       # whisper-small
    assert attn.head_plan(4, 16) == ("seq", 4)         # gemma3-1b
    assert attn.head_plan(64, 16) == ("shard", 64)
    assert attn.head_plan(40) == ("shard", 40)         # no policy: tp 1


@pytest.mark.parametrize("kvh,h,pad_to", [(2, 4, 0), (2, 4, 6), (1, 4, 8),
                                          (4, 4, 6)])
def test_expand_kv_and_pad_heads_match_reference(kvh, h, pad_to):
    kv = _rand(0, 2, 5, kvh, 8)
    got = attn.expand_kv(torch.from_numpy(kv), h, pad_to=pad_to)
    want = jattn.expand_kv(jnp.asarray(kv), h, pad_to=pad_to)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = _rand(1, 2, 5, h, 8)
    np.testing.assert_array_equal(
        attn.pad_heads(torch.from_numpy(q), pad_to).numpy(),
        np.asarray(jattn.pad_heads(jnp.asarray(q), pad_to)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_chunk", [4, 1024])
def test_kv_chunked_attention_matches_reference(causal, kv_chunk):
    q, k, v = (_rand(s, 2, 12, 3, 16) for s in (2, 3, 4))
    got = attn.kv_chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, kv_chunk=kv_chunk)
    want = jattn.kv_chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, kv_chunk=kv_chunk)
    close(got.numpy(), want, tol=1e-5)
    oracle = jattn.naive_reference_attention(*map(jnp.asarray, (q, k, v)),
                                             causal=causal)
    close(got.numpy(), oracle, tol=1e-5)


@pytest.mark.parametrize("window", [1, 5, 20])
def test_banded_attention_matches_reference(window):
    q, k, v = (_rand(s, 2, 12, 3, 16) for s in (5, 6, 7))
    got = attn.banded_attention(*map(torch.from_numpy, (q, k, v)),
                                window=window)
    want = jattn.banded_attention(*map(jnp.asarray, (q, k, v)),
                                  window=window)
    close(got.numpy(), want, tol=1e-5)
    oracle = attn.naive_reference_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True, window=window)
    close(got.numpy(), oracle.numpy(), tol=1e-5)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_naive_reference_attention_matches_reference(causal, window):
    q, k, v = _rand(8, 2, 9, 4, 8), _rand(9, 2, 9, 2, 8), _rand(10, 2, 9, 2, 8)
    got = attn.naive_reference_attention(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal, window=window)
    want = jattn.naive_reference_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal, window=window)
    close(got.numpy(), want, tol=1e-5)


# ---------------------------------------------------------------- repairs
def test_attention_out_masks_padded_heads():
    """Repair: ``wo`` with 6 heads for a 4-head model — the rows of the
    two padded heads are masked (the port raised here before)."""
    y, wo = _rand(11, 2, 3, 6, 8), _rand(12, 6, 8, 16)
    got = attn.attention_out({"wo": torch.from_numpy(wo)},
                             torch.from_numpy(y), 4)
    want = jattn.attention_out({"wo": jnp.asarray(wo)}, jnp.asarray(y), 4)
    close(got.numpy(), want, tol=1e-5)
    base = attn.attention_out({"wo": torch.from_numpy(wo[:4])},
                              torch.from_numpy(y[:, :, :4]), 4)
    close(got.numpy(), base.numpy(), tol=1e-6)


@pytest.mark.parametrize("window", [None, 3])
def test_fused_decode_adapter_takes_padded_heads(window):
    """Repair: q with 6 heads for a 4-head, 2-kv-head model — the model's
    4 heads go to the kernel (its plain version here), the padded two
    come back as zeros, as the reference's adapter does (the port raised
    here before)."""
    ps, num_pages = 4, 8
    q = _rand(13, 2, 1, 6, 8)
    ka, va = _rand(14, num_pages, ps, 2, 8), _rand(15, num_pages, ps, 2, 8)
    pages = np.array([[3, 1, 4], [0, 2, 8]], np.int32)
    lens = np.array([9, 6], np.int32)
    got = paged_decode_fused(*map(torch.from_numpy, (q, ka, va, pages,
                                                     lens)), 4,
                             window=window)
    want = jpaged_decode_fused(*map(jnp.asarray, (q, ka, va, pages, lens)),
                               4, window=window, interpret=True)
    assert tuple(got.shape) == want.shape == (2, 1, 6, 8)
    close(got.numpy(), want, tol=1e-5)
    assert not got[:, :, 4:].any()


# ------------------------------------------------------- model level: pad
PAD_MESH = {"data": 1, "model": 3}


@pytest.fixture
def pad_policy():
    with activation_sharding(MeshShape(PAD_MESH), ()):
        with jpolicy(FakeMesh(PAD_MESH), ()):
            yield


@functools.lru_cache(maxsize=None)
def pad_models(name):
    """JAX and port models and the reference's padded weights (built
    under the tp-3 policy, which the caller holds)."""
    jm, tm = jbuild(jget_arch(name).reduced()), build_model(
        get_arch(name).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def jitted(name, method, **static):
    """The reference model's ``method`` under ``jax.jit`` (traced under
    the tp-3 policy, which the caller holds)."""
    fn = getattr(pad_models(name)[0], method)
    return jax.jit(functools.partial(fn, **static))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", PAD_ARCHS)
def test_pad_plan_forward_and_prefill_match_reference(name, pad_policy):
    jm, jp, tm, tp = pad_models(name)
    wq = tp["periods"]["layer_0"]["mixer"]["wq"]
    assert wq.shape[-2] == 6 and tm.cfg.num_heads == 4
    tok = _tokens(1, 2, 20)
    jl, _ = jitted(name, "forward")(jp, {"tokens": jnp.asarray(tok)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
    close(tl.numpy(), jl, "forward")
    length = np.array([16, 11], np.int32)
    jl, jc = jitted(name, "prefill", max_len=24)(
        jp, {"tokens": jnp.asarray(tok[:, :16])}, length=jnp.asarray(length))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok[:, :16])},
                        max_len=24, length=torch.from_numpy(length))
    close(tl.numpy(), jl, "prefill")
    tokn = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(3):
        jl, jc = jitted(name, "decode_step")(jp, jc, jnp.asarray(tokn))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tokn))
        close(tl.numpy(), jl, f"contiguous decode {step}")
        tokn = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tokn)


@pytest.mark.parametrize("impl", ["gather", "fused"])
@pytest.mark.parametrize("name", PAD_ARCHS)
def test_pad_plan_paged_decode_matches_reference(name, impl, pad_policy):
    """Chunked prefill of a 10- and a 7-token prompt on a paged arena of
    page size 4, then 3 greedy decode steps through the gather path or
    the fused adapter (its plain version), 6 query heads for 4."""
    jm, jp, tm, tp = pad_models(name)
    ps, num_pages, c = 4, 12, 4
    pages = np.array([[3, 1, 4, 9, 12], [0, 2, 5, 12, 12]], np.int32)
    jc = jm.init_cache(num_pages, ps)
    jc["pages"] = jnp.asarray(pages)
    tc = tm.init_cache(num_pages, ps, "cpu")
    tc["pages"] = torch.from_numpy(pages)
    prompts = [_tokens(3, 1, 10)[0], _tokens(4, 1, 7)[0]]
    last = [None, None]
    for start in range(0, 10, c):
        tok = np.zeros((2, c), np.int32)
        qpos = np.tile(np.arange(start, start + c, dtype=np.int32), (2, 1))
        wpos = np.full((2, c), _DROP_POS, np.int32)
        n_live = [max(0, min(c, pr.size - start)) for pr in prompts]
        for b, (pr, n) in enumerate(zip(prompts, n_live)):
            tok[b, :n] = pr[start:start + n]
            wpos[b, :n] = qpos[b, :n]
        jl, jc = jitted(name, "prefill_chunk")(
            jp, jc, *map(jnp.asarray, (tok, qpos, wpos)))
        tl, tc = tm.prefill_chunk(tp, tc, *map(torch.from_numpy,
                                               (tok, qpos, wpos)))
        close(tl.numpy(), jl, f"chunk at {start}")
        for b, n in enumerate(n_live):
            if n:
                last[b] = np.asarray(jl)[b, n - 1]
    tok = np.array([int(np.argmax(x)) for x in last], np.int32)
    jc["len"] = jnp.asarray([10, 7], dtype=jnp.int32)
    tc["len"] = torch.tensor([10, 7], dtype=torch.int32)
    for step in range(3):
        jl, jc = jitted(name, "decode_step", attn_impl=impl)(
            jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                attn_impl=impl)
        close(tl.numpy(), jl, f"{impl} decode {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)


def test_pad_plan_whisper_matches_reference(pad_policy):
    """whisper-small (12 heads, reduced to 4, stored as 6 in the
    encoder's, the decoder's self and cross attention): ``encode``, the
    teacher-forced loss, ``prefill`` and 4 decode steps from the
    reference's prefill cache (the reference has no logits forward for
    it)."""
    jm, jp, tm, tp = pad_models("whisper-small")
    assert tp["encoder"]["periods"]["attn"]["wq"].shape[-2] == 6
    emb = _rand(20, 2, 12, 128)
    tok = _tokens(21, 2, 7)
    close(tm.encode(tp, torch.from_numpy(emb)).numpy(),
          jm.encode(jp, jnp.asarray(emb)), "encode")
    jbatch = {"embeds": jnp.asarray(emb), "tokens": jnp.asarray(tok[:, :6]),
              "labels": jnp.asarray(tok[:, 1:])}
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    close(float(tm.loss_fn(tp, tbatch)[0]), float(jm.loss_fn(jp, jbatch)[0]),
          "loss", tol=1e-5)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb)})
    tl, _ = tm.prefill(tp, {"embeds": torch.from_numpy(emb)})
    close(tl.numpy(), jl, "prefill")
    tc = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tokn = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(4):
        jl, jc = jitted("whisper-small", "decode_step")(jp, jc,
                                                         jnp.asarray(tokn))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tokn))
        close(tl.numpy(), jl, f"decode {step}")
        tokn = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tokn)


@pytest.mark.parametrize("name", ["qwen3-14b"])
def test_pad_plan_engine_matches_reference(name, pad_policy):
    """The main path (paged, chunked, fused, bucketed) under the tp-3
    plan: greedy streams, ``grant_log`` and allocator acquires equal to
    the JAX engine's; the pool drains."""
    jm, jp, tm, tp = pad_models(name)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, 512, size=int(rng.integers(3, 15))).astype(
        np.int32), int(rng.integers(2, 6))) for _ in range(5)]
    kw = dict(capacity=3, max_len=24, decode_chunk=2, kv_layout="paged",
              page_size=4, prefill_chunk_tokens=4, attention_impl="fused",
              bucketed_dispatch="on")

    def run(cls, model, params, extra):
        eng = cls(model, params, **kw, **extra)
        hs = [eng.submit(p, n) for p, n in reqs]
        eng.run_until_done()
        eng.pool.check()
        assert eng.pool.pages.in_use == 0
        return ({r.rid: list(r.out_tokens) for r in hs}, list(eng.grant_log),
                eng.pool.pages.lock_stats()["acquires"])

    want = run(JEngine, jm, jp, {"seed": 0})
    got = run(SlotServeEngine, tm, tp, {"device": "cpu"})
    assert got == want
    assert [len(s) for s in got[0].values()] == [n for _, n in reqs]


# ------------------------------------------------------- model level: seq
SEQ_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import build_model
from repro.models.attention import head_plan
from repro.sharding.act import activation_sharding

mesh = jax.make_mesh((1, 8), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
m = build_model(get_arch("gemma3-1b").reduced())
tok = np.random.default_rng(30).integers(0, 512, (2, 32)).astype(np.int32)
with activation_sharding(mesh, ("data",)):
    assert head_plan(m.cfg.num_heads) == ("seq", 4)
    params = m.init(jax.random.PRNGKey(0))
    logits, _ = jax.jit(m.forward)(params, {"tokens": jnp.asarray(tok)})
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(sys.argv[1], tokens=tok, logits=np.asarray(logits),
         **{"p:" + k: v for k, v in flat.items()})
print("SEQ_OK")
"""


@pytest.fixture(scope="module")
def seq_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq") / "seq.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SEQ_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SEQ_OK" in proc.stdout
    return dict(np.load(out))


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        if not key.startswith("p:"):
            continue
        node = tree
        *parents, leaf = key[2:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_seq_plan_forward_matches_reference_mesh(seq_reference):
    """gemma3-1b reduced (4 heads, window 8) at tp 8 — the ``'seq'``
    plan: local layers banded, the global layer kv-chunked — against
    the JAX forward under a real (1, 8) host-device mesh with its
    sequence constraints, on the reference's weights."""
    tm = build_model(get_arch("gemma3-1b").reduced())
    with activation_sharding(MeshShape({"data": 1, "model": 8}),
                             ("data",)):
        assert attn.head_plan(tm.cfg.num_heads) == ("seq", 4)
        tp = params_from_numpy(tm, _unflatten(seq_reference), "cpu")
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(
            seq_reference["tokens"])})
    close(tl.numpy(), seq_reference["logits"], "seq forward")
    # the 'shard' plan (no policy) on the same weights: blocked attention
    ts, _ = tm.forward(tp, {"tokens": torch.from_numpy(
        seq_reference["tokens"])})
    close(tl.numpy(), ts.numpy(), "seq vs shard")


def test_seq_plan_paths_are_taken(monkeypatch):
    """Under tp 8, gemma3's local layers take ``banded_attention`` and its
    global layer ``kv_chunked_attention``; with no policy both take
    ``blocked_attention``."""
    tm = build_model(get_arch("gemma3-1b").reduced())
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    for fn in ("banded_attention", "kv_chunked_attention",
               "blocked_attention"):
        real = getattr(attn, fn)
        monkeypatch.setattr(attn, fn, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k),
            real, fn))
    tok = torch.from_numpy(_tokens(31, 1, 16))
    with activation_sharding(MeshShape({"data": 1, "model": 8}), ()):
        tm.forward(tp, {"tokens": tok})
    n_local = sum(k == "local" for k in tm.cfg.layer_pattern)
    assert calls.count("banded_attention") == n_local
    assert calls.count("kv_chunked_attention") == tm.cfg.num_layers - n_local
    calls.clear()
    tm.forward(tp, {"tokens": tok})
    assert calls == ["blocked_attention"] * tm.cfg.num_layers


# --------------------------------------------------------------- report
def _err(want, got):
    return float(np.max(np.abs(np.asarray(want) - np.asarray(got))))


def report_rows():
    """The largest errors at this module's shapes, for the parity table
    (the tests assert the tolerances; this reports how far inside them
    the port lands): the units against the reference with no policy;
    the reduced models under the tp-3 ``'pad'`` plan (each row: max
    |err| and max |ref|); gemma3's ``'seq'`` forward against the
    reference under a (1, 8) host-device mesh (a subprocess) and against
    the port's ``'shard'`` forward."""
    import tempfile

    def t(*xs):
        return [torch.from_numpy(x) for x in xs]

    rows = {}
    q, k, v = (_rand(s, 2, 12, 3, 16) for s in (2, 3, 4))
    rows["kv_chunked_attention (causal, 3 chunks of 4)"] = _err(
        jattn.kv_chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, kv_chunk=4),
        attn.kv_chunked_attention(*t(q, k, v), causal=True, kv_chunk=4))
    rows["banded_attention (window 5)"] = _err(
        jattn.banded_attention(*map(jnp.asarray, (q, k, v)), window=5),
        attn.banded_attention(*t(q, k, v), window=5))
    y, wo = _rand(11, 2, 3, 6, 8), _rand(12, 6, 8, 16)
    rows["attention_out, wo padded 4 -> 6 heads"] = _err(
        jattn.attention_out({"wo": jnp.asarray(wo)}, jnp.asarray(y), 4),
        attn.attention_out({"wo": torch.from_numpy(wo)},
                           torch.from_numpy(y), 4))
    mesh = {"data": 1, "model": 3}
    with jpolicy(FakeMesh(mesh), ()), activation_sharding(
            MeshShape(mesh), ()):
        for name in ("qwen3-14b", "minitron-4b", "gemma3-1b"):
            jm, jp, tm, tp = pad_models(name)
            tok = _tokens(1, 2, 20)
            jlog, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
            tlog, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
            rows[f"pad plan tp 3 LM.forward {name} (max |ref| "
                 f"{float(np.abs(np.asarray(jlog)).max()):.3g})"] = _err(
                     jlog, tlog)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "seq.npz")
        subprocess.run([sys.executable, "-c", SEQ_SCRIPT, npz], env=env,
                       check=True, capture_output=True, timeout=240)
        ref = dict(np.load(npz))
    tm = build_model(get_arch("gemma3-1b").reduced())
    tokens = torch.from_numpy(ref["tokens"])
    with activation_sharding(MeshShape({"data": 1, "model": 8}), ("data",)):
        tp = params_from_numpy(tm, _unflatten(ref), "cpu")
        seq, _ = tm.forward(tp, {"tokens": tokens})
    shard, _ = tm.forward(tp, {"tokens": tokens})
    rows["seq plan tp 8 gemma3 LM.forward vs JAX on a (1, 8) mesh (max "
         f"|ref| {float(np.abs(ref['logits']).max()):.3g})"] = _err(
             ref["logits"], seq)
    rows["seq plan tp 8 gemma3 LM.forward vs the port's shard plan"] = _err(
        shard, seq)
    return rows


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_head_plans.py
    import json
    for name, e in report_rows().items():
        print(json.dumps({"function": name, "max_abs_err": e}))
