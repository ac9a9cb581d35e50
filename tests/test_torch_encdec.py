"""The encoder-decoder and stub-frontend families of the JAX package
through the port's model paths, reduced, float32: ``whisper-small``
(``EncDecLM``: 2 encoder and 2 decoder layers, GELU, tied embeddings)
and ``internvl2-76b`` (the decoder-only ``LM`` on precomputed
embeddings, untied head, no ``embed`` leaf). Weights are the JAX
``init``'s, carried over by ``models.bridge``.

Against the JAX models on the same numpy-seeded frames, embeddings and
tokens: whisper's ``encode``, ``prefill`` (logits, the cross and self
caches, the length) and 8 ``decode_step``s at a scalar and at a per-row
``[B]`` length (one row running past the self cache, whose writes drop);
internvl's ``forward``, ``prefill`` with and without ``length=`` and
``decode_step`` on ``[B, D]`` embeddings; the legacy ``ServeEngine``'s
greedy whisper streams (exactly equal); the encoder-decoder ``SlotPool``
arena (the capacity on every leaf's batch axis, as the reference's).
The legacy engine cannot serve internvl in either package (its sampled
ids are not embeddings), so only the model path is held for it.

TOL is 1e-4 relative to the reference's largest |value| (at least 1e-4
absolute), as in tests/test_torch_families.py. Reduced whisper's
stacked encoder weights are drawn at std 1/sqrt(2) (the fan-in quirk),
so its attention scores reach ~1e3 and float32 rounding in the encoder
moves the cross K/V by ~6.5e-5 of their range, which decode amplifies
to ~1.2e-4 of the logits' (my CPU run): its decode steps are held at
TOL on the reference's own prefill cache, and end to end by the greedy
streams."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_slots import SlotPool as JSlotPool
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import check_matches, params_from_numpy
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_slots import SlotPool, batch_axes, cache_leaves

TOL = 1e-4


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
def jdecode(name):
    """The reference model's ``decode_step`` under ``jax.jit`` (as its
    engine runs it; op by op it is several times slower)."""
    return jax.jit(models(name)[0].decode_step)


@functools.lru_cache(maxsize=None)
def models(name):
    jm, tm = jbuild(jget_arch(name).reduced()), build_model(
        get_arch(name).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def close(got, want, what=""):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=what)


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------ whisper-small
def test_whisper_tree_and_encode_match_reference():
    jm, jp, tm, tp = models("whisper-small")
    check_matches(tm, jax.tree_util.tree_map(np.asarray, jp))
    assert "lm_head" not in tp and tm.cfg.encoder_layers == 2
    emb = _frames(0, 2, 12, 128)
    close(tm.encode(tp, torch.from_numpy(emb)).numpy(),
          jm.encode(jp, jnp.asarray(emb)))


def _whisper_prefill():
    jm, jp, tm, tp = models("whisper-small")
    emb = _frames(0, 2, 12, 128)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb)})
    tl, tc = tm.prefill(tp, {"embeds": torch.from_numpy(emb)})
    return (jl, jc), (tl, tc)


def test_whisper_prefill_matches_reference():
    """Cross K/V of every layer, the self cache after BOS (sized by
    ``decoder_len``), the scalar length 1 and BOS's logits."""
    (jl, jc), (tl, tc) = _whisper_prefill()
    close(tl.numpy(), jl, "logits")
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jc)))
    got = dict(tree_leaves(tc))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        close(got[path].numpy(), want[path], path)
    assert tc["self"]["k"].shape[2] == 16 and int(tc["len"]) == 1


@pytest.mark.parametrize("lens", [None, (1, 13)], ids=["scalar", "per-row"])
def test_whisper_decode_matches_reference(lens):
    """8 greedy steps from the reference's prefill cache: logits within
    TOL, the same tokens, the self caches close after. Per-row lengths
    1 and 13: the second row passes the 16-position self cache after 3
    steps and its writes drop in both packages."""
    jm, jp, tm, tp = models("whisper-small")
    (jl, jc), _ = _whisper_prefill()
    if lens is not None:
        jc = dict(jc, len=jnp.asarray(lens, jnp.int32))
    tc = _to_torch(jc)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(8):
        jl, jc = jdecode("whisper-small")(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        close(tl.numpy(), jl, f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
    assert np.array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for name in ("k", "v"):
        close(tc["self"][name].numpy(), jc["self"][name], name)


def test_whisper_legacy_engine_streams_equal_reference():
    """The legacy engine (the only one that serves an encoder-decoder)
    on an ``{"embeds": ...}`` batch: greedy streams exactly equal to
    the JAX engine's, prefill included."""
    jm, jp, tm, tp = models("whisper-small")
    emb = _frames(3, 3, 10, 128)
    want = JServeEngine(jm, jp).generate({"embeds": jnp.asarray(emb)}, 10)
    got = ServeEngine(tm, tp).generate({"embeds": torch.from_numpy(emb)}, 10)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.tokens.shape == (3, 10)


def test_whisper_slot_pool_layout_equals_reference():
    """The reference's pool finds every leaf's batch axis by probing; the
    port states them: the same axes, the arena's leaves in the same
    order with the same shapes, the capacity on every batch axis."""
    jm, _, tm, _ = models("whisper-small")
    jpool = JSlotPool(jm, capacity=2, max_len=8)
    tpool = SlotPool(tm, capacity=2, max_len=8, device="cpu")
    assert batch_axes(tm) == jpool._axes == [1, 1, 1, 1]
    jleaves = jax.tree_util.tree_flatten_with_path(jpool.arena)[0]
    tleaves = cache_leaves(tpool.arena)
    assert [(g, n) for g, _, n, _ in tleaves] == [
        (p[0].key, p[1].key) for p, _ in jleaves]
    assert [tuple(a.shape) for *_, a in tleaves] == [
        tuple(a.shape) for _, a in jleaves]
    assert all(a.shape[1] == 2 for *_, a in tleaves)


# ------------------------------------------------------------ internvl2-76b
def test_internvl_tree_and_forward_match_reference():
    jm, jp, tm, tp = models("internvl2-76b")
    check_matches(tm, jax.tree_util.tree_map(np.asarray, jp))
    assert "embed" not in tp and "lm_head" in tp
    emb = _frames(1, 2, 16, 128)
    jl, ja = jm.forward(jp, {"embeds": jnp.asarray(emb)})
    tl, ta = tm.forward(tp, {"embeds": torch.from_numpy(emb)})
    close(tl.numpy(), jl)
    assert ta == {} and dict(ja) == {}


@pytest.mark.parametrize("length", [None, (16, 11)], ids=["exact", "padded"])
def test_internvl_prefill_and_decode_on_embeddings(length):
    """Prefill on 16 embedding positions (with per-row lengths: the
    right-padded form), then 8 decode steps each fed a fresh ``[B, D]``
    embedding (the next-embed stub, never read as ids): logits and
    every cache leaf within TOL."""
    jm, jp, tm, tp = models("internvl2-76b")
    emb = _frames(2, 2, 16, 128)
    kw_j = {} if length is None else {"length": jnp.asarray(length)}
    kw_t = {} if length is None else {"length": torch.tensor(length)}
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb)}, max_len=24,
                        **kw_j)
    tl, tc = tm.prefill(tp, {"embeds": torch.from_numpy(emb)}, max_len=24,
                        **kw_t)
    close(tl.numpy(), jl, "prefill")
    for step in range(8):
        nxt = _frames(10 + step, 2, 1, 128)[:, 0]
        jl, jc = jdecode("internvl2-76b")(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        close(tl.numpy(), jl, f"step {step}")
    want = dict(tree_leaves(jax.tree_util.tree_map(
        np.asarray, {k: jc[k] for k in ("periods", "leftover")})))
    got = dict(tree_leaves({k: tc[k] for k in ("periods", "leftover")}))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path].numpy(), want[path], path)
    assert np.array_equal(np.asarray(tc["len"]), np.asarray(jc["len"]))


def test_internvl_prefill_then_decode_equals_forward():
    """Prefill on 15 embeddings and a decode step on the 16th equals the
    forward's last position, as the reference's own
    ``test_prefill_decode_matches_forward`` holds for token models."""
    _, _, tm, tp = models("internvl2-76b")
    emb = torch.from_numpy(_frames(4, 2, 16, 128))
    full, _ = tm.forward(tp, {"embeds": emb})
    _, cache = tm.prefill(tp, {"embeds": emb[:, :15]}, max_len=16)
    last, _ = tm.decode_step(tp, cache, emb[:, 15])
    close(last.numpy(), full[:, 15].numpy())
