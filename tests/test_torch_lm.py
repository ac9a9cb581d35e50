"""Reduced qwen3-14b through the weight bridge: the port's
``LM.prefill_chunk`` and ``LM.decode_step`` against the JAX ``LM`` on
the same paged cache — logits within TOL (max abs, float32), greedy
tokens identical over several steps, arenas equal after — plus the
bridge's round trip: every leaf of the reference's parameter tree maps
to exactly one parameter of the port with the same shape, and nothing
of the port's is left unmapped."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.configs import SSMConfig, get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import (check_matches, leaf_shapes,
                                       params_from_numpy)
from repro_torch.serve.engine import _DROP_POS

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch("qwen3-14b").reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tm = build_model(get_arch("qwen3-14b").reduced())
    return jm, jp, np_tree, tm, params_from_numpy(tm, np_tree, "cpu")


def test_bridge_maps_every_leaf_once(models):
    _, _, np_tree, tm, tp = models
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                np_tree)[0]}
    assert leaf_shapes(tm.spec_tree()) == want
    assert leaf_shapes(tp) == want
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        node = tp
        for k in path:
            node = node[k.key]
        assert np.array_equal(node.numpy(), leaf)


def test_bridge_refuses_partial_or_misshapen_trees(models):
    _, _, np_tree, tm, _ = models
    missing = {k: v for k, v in np_tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing.*final_norm"):
        check_matches(tm, missing)
    extra = dict(np_tree, lm_head={"kernel": np.zeros((128, 512))})
    with pytest.raises(ValueError, match="unexpected.*lm_head"):
        check_matches(tm, extra)
    bad = dict(np_tree, final_norm={"scale": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="shapes differ"):
        check_matches(tm, bad)


def test_bridge_carries_bfloat16_exactly():
    jcfg = dataclasses.replace(jget_arch("qwen3-14b").reduced(),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch("qwen3-14b").reduced(),
                               param_dtype="bfloat16")
    np_tree = jax.tree_util.tree_map(
        np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_numpy(build_model(tcfg), np_tree, "cpu")
    w = tp["periods"]["layer_0"]["mixer"]["wq"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.float().numpy(),
                          np_tree["periods"]["layer_0"]["mixer"]["wq"]
                          .astype(np.float32))


def test_port_init_matches_spec():
    tm = build_model(get_arch("qwen3-14b").reduced())
    p = tm.init(torch.Generator().manual_seed(0), "cpu")
    check_matches(tm, p)
    assert bool((p["final_norm"]["scale"] == 1).all())


def test_unported_families_raise():
    """Mamba blocks were outside earlier slices and now build (held to
    the JAX package in tests/test_torch_ssm_families.py); since the
    encoder-decoder slice so do whisper-small and internvl2-76b. What
    still refuses them is what the reference refuses them with: the slot
    engine and the serving launcher (token LMs only). (The mesh
    all-reduce of compressed gradients refused here too before the mesh
    slice; it now computes over a ``DeviceMesh``, held to the JAX
    package in tests/test_torch_mesh_world.py.)"""
    from repro_torch.launch import serve
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.serve.engine import SlotServeEngine
    cfg = get_arch("qwen3-14b").reduced()
    spec = build_model(dataclasses.replace(cfg, layer_pattern=("mamba",),
                                           ssm=SSMConfig())).spec_tree()
    assert "A_log" in spec["periods"]["layer_0"]["mixer"]
    assert get_arch("falcon-mamba-7b").attention_free
    assert isinstance(build_model(get_arch("whisper-small")), EncDecLM)
    assert "embed" not in build_model(get_arch("internvl2-76b")).spec_tree()
    for name in ("whisper-small", "internvl2-76b"):
        model = build_model(get_arch(name).reduced())
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="decoder-only token LMs"):
            SlotServeEngine(model, params, capacity=2, max_len=16,
                            device="cpu")
        with pytest.raises(SystemExit, match="token-LM archs"):
            serve.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--requests", "1"])


def _caches(jm, tm, pages, ps, num_pages):
    jc = jm.init_cache(num_pages, ps)
    jc["pages"] = jnp.asarray(pages)
    tc = tm.init_cache(num_pages, ps, "cpu")
    tc["pages"] = torch.from_numpy(pages)
    return jc, tc


def _arenas_close(jc, tc):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc["periods"]["layer_0"][name].numpy(),
            np.asarray(jc["periods"]["layer_0"][name]), atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_prefill_chunks_then_greedy_decode(models, impl):
    """Two rows prefill a 7- and a 5-token prompt in chunks of 4 (the
    ragged lanes parked at the drop sentinel), then decode 4 greedy
    tokens each — logits within TOL at every call, tokens identical."""
    jm, jp, _, tm, tp = models
    ps, num_pages, c = 4, 10, 4
    pages = np.array([[3, 1, 4, 10, 10], [0, 2, 5, 10, 10]], np.int32)
    jc, tc = _caches(jm, tm, pages, ps, num_pages)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 7), rng.integers(0, 512, 5)]
    jchunk = jax.jit(jm.prefill_chunk)
    last = []
    for start in (0, 4):
        tok = np.zeros((2, c), np.int32)
        qpos = np.tile(np.arange(start, start + c, dtype=np.int32), (2, 1))
        wpos = np.full((2, c), _DROP_POS, np.int32)
        for b, pr in enumerate(prompts):
            v = max(0, min(c, pr.size - start))
            tok[b, :v] = pr[start:start + v]
            wpos[b, :v] = qpos[b, :v]
        jl, jc = jchunk(jp, jc, *map(jnp.asarray, (tok, qpos, wpos)))
        tl, tc = tm.prefill_chunk(tp, tc, *map(torch.from_numpy,
                                               (tok, qpos, wpos)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        last.append(tl)
    tok = np.array([int(last[1][0, 2].argmax()), int(last[1][1, 0].argmax())],
                   np.int32)
    lens = np.array([7, 5], np.int32)
    jc["len"] = jnp.asarray(lens)
    tc["len"] = torch.from_numpy(lens)
    jdec = jax.jit(jm.decode_step, static_argnames=("attn_impl",))
    for _ in range(4):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), attn_impl=impl)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        jt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        tt = tl.argmax(dim=-1).numpy().astype(np.int32)
        assert np.array_equal(jt, tt)
        tok = tt
    assert tc["len"].tolist() == [11, 9]
    _arenas_close(jc, tc)


def test_decode_step_requires_the_paged_cache(models):
    """Only the paged path reads ``cache["pages"]``: a cache without it
    (formerly refused) takes the contiguous path, which matches the
    reference's (held in full by tests/test_torch_prefill.py)."""
    jm, jp, _, tm, tp = models
    tok = np.array([3, 4], np.int32)
    jl, _ = jm.decode_step(jp, jm.init_cache(2, 4), jnp.asarray(tok))
    tl, tc = tm.decode_step(tp, tm.init_cache(2, 4, "cpu"),
                            torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert "pages" not in tc and int(tc["len"]) == 1
