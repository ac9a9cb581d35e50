"""The training substrate against the JAX package: the optimizer, the
train step, the data pipeline, checkpointing, gradient compression and
the cluster coordinator.

* ``optimizer``: one AdamW update (with and without the factored second
  moment and clipping) equal to the reference's within 1e-6; the
  schedule; the reference's own optimizer tests restated on the port.
* ``train_loop``: three train steps of reduced qwen3-14b at 1 and at 2
  microbatches (remat on): losses within 1e-5, params within 1e-5 of the
  reference's but for the few elements (at most one in 10^4 of a leaf;
  1-4 in all, up to 3.3e-5, in my CPU run) whose gradient sits at
  float32 noise, which Adam turns into full-size updates
  (``adam_close``); 2 microbatches within 1e-5 of 1 everywhere;
  training reduces the loss.
* ``data``: ``SyntheticLM`` and ``BinTokens`` batches equal to the
  reference's by seed, start step and offset; the prefetcher.
* ``checkpoint``: the reference's layout and keys; a float32 checkpoint
  written by either package restores in the other; bfloat16 leaves are
  written byte for byte as the reference writes them and restore in the
  port (the reference's own restore refuses them: it cannot resume a
  bfloat16 run); the reference's checkpoint tests restated.
* ``compression``: quantization, error feedback and the tree form equal
  to the reference's; its tests restated; the mesh all-reduce refuses.
* ``coordinator``: the reference's tests restated on the port.

Float32 throughout, inputs from numpy seeds, the reference's weights
through the bridge."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.coordinator import (ClusterCoordinator, InMemoryKV,
                                          KVCoordinator)
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import BinTokens, Prefetcher, SyntheticLM
from repro_torch.train.train_loop import make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny reduced models gain nothing from intra-op threads, and the
    suite's workers share the CPU: one thread each keeps this module's
    runs from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(tree):
    """A JAX tree as {path: numpy array}."""
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tnp(tree):
    """A port tree as {path: numpy array}."""
    return {p: v.numpy() for p, v in tree_leaves(tree)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------- optimizer
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((24, 32)).astype(np.float32),
            "stack": {"k": rng.standard_normal((2, 16, 20)).astype(
                np.float32)},
            "b": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_update_matches_reference(factored, clip):
    """Two updates from zero state (the second with live moments):
    params, moments and metrics within 1e-6."""
    kw = dict(peak_lr=0.05, warmup_steps=2, total_steps=50,
              factored_second_moment=factored, clip_norm=clip)
    jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    p = _opt_tree(0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), _t(p)
    js, ts = jopt.init(jcfg, jp), opt.init(tcfg, tp)
    assert isinstance(ts.v["w"], dict) == factored
    for step in range(2):
        g = jax.tree_util.tree_map(lambda a: 3.0 * a, _opt_tree(10 + step))
        jp, js, jm = jopt.update(jcfg, jax.tree_util.tree_map(
            jnp.asarray, g), js, jp)
        tp, ts, tm = opt.update(tcfg, _t(g), ts, tp)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            w, gt = _jnp(want), _tnp(got)
            assert sorted(w) == sorted(gt)
            for k in w:
                np.testing.assert_allclose(gt[k], w[k], atol=1e-6, rtol=0,
                                           err_msg=k)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * max(
                1.0, abs(float(jm[k]))), k
        assert int(ts.count) == int(js.count) == step + 1


def test_schedule_matches_reference():
    cfg = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert abs(float(opt.schedule(opt.AdamWConfig(**cfg),
                                      torch.tensor(step)))
                   - float(jopt.schedule(jopt.AdamWConfig(**cfg),
                                         jnp.asarray(step)))) <= 1e-7


def test_adamw_minimizes_quadratic():
    cfg = opt.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                          weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(cfg, params)
    for _ in range(150):
        params, state, _ = opt.update(cfg, {"w": 2 * params["w"]}, state,
                                      params)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_factored_tracks_full():
    full = opt.AdamWConfig(peak_lr=0.05, warmup_steps=2, total_steps=100,
                           weight_decay=0.0, clip_norm=None)
    fact = opt.AdamWConfig(peak_lr=0.05, warmup_steps=2, total_steps=100,
                           weight_decay=0.0, clip_norm=None,
                           factored_second_moment=True)
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((24, 32)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((24, 32)).astype(
        np.float32))
    pf, pk = {"w": w0}, {"w": w0}
    sf, sk = opt.init(full, pf), opt.init(fact, pk)
    assert isinstance(sk.v["w"], dict)
    for _ in range(60):
        pf, sf, _ = opt.update(full, {"w": pf["w"] - target}, sf, pf)
        pk, sk, _ = opt.update(fact, {"w": pk["w"] - target}, sk, pk)
    err_full = float((pf["w"] - target).abs().mean())
    err_fact = float((pk["w"] - target).abs().mean())
    assert err_fact < 3 * err_full + 0.05


def test_grad_clip_and_schedule():
    cfg = opt.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          clip_norm=1.0)
    assert float(opt.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(opt.schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(opt.schedule(cfg, torch.tensor(100))) <= 0.11
    params = {"w": torch.zeros(4)}
    _, _, m = opt.update(cfg, {"w": torch.full((4,), 100.0)},
                         opt.init(cfg, params), params)
    assert float(m["grad_norm"]) > 100


def test_update_keeps_dtypes_and_decays_matrices_only():
    """bfloat16 params come back bfloat16, moments float32 (the first in
    ``momentum_dtype``); with a zero gradient only the matrix moves."""
    cfg = opt.AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=10,
                          momentum_dtype="bfloat16")
    params = {"w": torch.ones((3, 4), dtype=torch.bfloat16),
              "b": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(cfg, params)
    grads = tree_map(torch.zeros_like, params)
    new, state, _ = opt.update(cfg, grads, state, params)
    assert new["w"].dtype == new["b"].dtype == torch.bfloat16
    assert state.m["w"].dtype == torch.bfloat16
    assert state.v["w"].dtype == torch.float32
    assert bool((new["w"] < 1).all()) and bool((new["b"] == 1).all())


# --------------------------------------------------------------- train loop
def adam_close(got, want, lr_sum, what=""):
    """Params of two packages after some Adam steps, equal within 1e-5
    but where Adam amplified float32 noise: an element whose gradient
    sits at the rounding level of its leaf (~1e-8 against ~1e-2) gets a
    full-size update whose size that rounding decides. At most one
    element in 10^4 of a leaf (at least one) may pass 1e-5, and none the
    most two runs' Adam updates can part, 2 x the summed learning
    rates."""
    want = np.asarray(want)
    d = np.abs(np.asarray(got) - want)
    assert d.max() <= 2 * lr_sum, (what, d.max())
    assert (d > 1e-5).sum() <= max(1, want.size // 10_000), (
        what, int((d > 1e-5).sum()), d.max())


@pytest.fixture(scope="module")
def qwen():
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


OCFG = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _three_steps(jm, jp, tm, tp, mb):
    ocfg = OCFG
    jstep = jax.jit(jmake_train_step(jm, jopt.AdamWConfig(**ocfg),
                                     num_microbatches=mb, remat=mb > 1))
    tstep = make_train_step(tm, opt.AdamWConfig(**ocfg),
                            num_microbatches=mb, remat=mb > 1)
    js, ts = jopt.init(jopt.AdamWConfig(**ocfg), jp), opt.init(
        opt.AdamWConfig(**ocfg), tp)
    ds = jdata.SyntheticLM(512, 4, 16, seed=5)
    for _ in range(3):
        raw = next(ds)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in raw.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in raw.items()})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * max(
            1.0, abs(float(jmet["loss"])))
    return jp, tp


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_reference(qwen, mb):
    jm, jp, tm, tp = qwen
    jp3, tp3 = _three_steps(jm, jp, tm, tp, mb)
    want, got = _jnp(jp3), dict(tree_leaves(tp3))
    assert sorted(want) == sorted(got)
    lr_sum = sum(float(jopt.schedule(jopt.AdamWConfig(**OCFG),
                                     jnp.asarray(t))) for t in (1, 2, 3))
    for k in want:
        adam_close(got[k].numpy(), want[k], lr_sum, k)


def test_microbatch_accumulation_matches_full_batch(qwen):
    """2 microbatches (remat on) give 1 microbatch's update within
    1e-5."""
    _, _, tm, tp = qwen
    ocfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (4, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    p1, _, _ = make_train_step(tm, ocfg, num_microbatches=1, remat=False)(
        tp, opt.init(ocfg, tp), batch)
    p2, _, _ = make_train_step(tm, ocfg, num_microbatches=2, remat=True)(
        tp, opt.init(ocfg, tp), batch)
    for (k, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_train_step_leaves_inputs_and_applies_grad_transform(qwen):
    """The step builds new trees (the inputs are unchanged) and hands the
    averaged gradients to ``grad_transform`` before the update."""
    _, _, tm, tp = qwen
    ocfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    before = tree_map(torch.clone, tp)
    seen = []

    def transform(g):
        seen.append(g)
        return comp.apply_compression(g, comp.make_feedback_state(g))[0]

    raw = next(SyntheticLM(512, 2, 8, seed=0))
    new, state, met = make_train_step(tm, ocfg, remat=False,
                                      grad_transform=transform)(
        tp, opt.init(ocfg, tp), {k: torch.from_numpy(v)
                                 for k, v in raw.items()})
    assert len(seen) == 1 and int(state.count) == 1
    assert {"loss", "tokens", "grad_norm", "lr"} <= set(met)
    for (k, a), (_, b) in zip(tree_leaves(before), tree_leaves(tp)):
        assert torch.equal(a, b), k
    assert any(not torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_leaves(tp), tree_leaves(new)))


def test_training_reduces_loss():
    tm = build_model(get_arch("olmoe-1b-7b").reduced())
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    ocfg = opt.AdamWConfig(peak_lr=2e-3, warmup_steps=3, total_steps=30)
    state = opt.init(ocfg, params)
    step = make_train_step(tm, ocfg, num_microbatches=1, remat=True)
    losses = []
    for i, raw in enumerate(SyntheticLM(512, 4, 24, seed=3)):
        params, state, met = step(params, state, {
            k: torch.from_numpy(v) for k, v in raw.items()})
        losses.append(float(met["loss"]))
        if i >= 7:
            break
    assert losses[-1] < losses[0]


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,start", [(0, 0), (1, 5), (7, 4)])
def test_synthetic_stream_equals_reference(seed, start):
    a = SyntheticLM(100, 2, 8, seed=seed, start_step=start)
    b = jdata.SyntheticLM(100, 2, 8, seed=seed, start_step=start)
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in y:
            assert x[k].dtype == y[k].dtype
            assert np.array_equal(x[k], y[k])
    assert a.state() == b.state() == {"step": start + 3, "seed": seed}


def test_synthetic_data_resumable():
    a = SyntheticLM(100, 2, 8, seed=1, start_step=5)
    b = SyntheticLM(100, 2, 8, seed=1, start_step=5)
    np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    batch = next(SyntheticLM(100, 2, 8, seed=2))
    assert batch["tokens"].shape == batch["labels"].shape == (2, 8)


def test_bin_tokens_equal_reference_and_prefetch(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(4000, dtype=np.uint16).tofile(path)
    ds = BinTokens(path, vocab_size=500, batch=2, seq_len=16,
                   start_offset=3900)
    ref = jdata.BinTokens(path, vocab_size=500, batch=2, seq_len=16,
                          start_offset=3900)
    for _ in range(3):             # the second wraps to the next epoch
        x, y = next(ds), next(ref)
        for k in y:
            assert np.array_equal(x[k], y[k])
    assert ds.state() == ref.state()
    assert next(ds)["tokens"].max() < 500
    pf = Prefetcher(ds, depth=2)
    assert next(pf)["tokens"].shape == (2, 16)
    pf.close()
    with pytest.raises(ValueError, match="smaller than one batch"):
        BinTokens(path, vocab_size=500, batch=200, seq_len=40)


def test_prefetcher_ends_with_its_source():
    pf = Prefetcher(iter([{"a": 1}, {"a": 2}]), depth=1)
    assert [b["a"] for b in pf] == [1, 2]
    pf.close()


# --------------------------------------------------------------- checkpoint
def _train_tree(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    p = {"periods": {"layer_0": {"w": rng.standard_normal((2, 8, 4))}},
         "embed": {"tokens": rng.standard_normal((16, 8))},
         "final_norm": {"scale": rng.standard_normal(8)}}
    params = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)).to(
        dtype), p)
    state = opt.init(opt.AdamWConfig(), params)
    m = tree_map(lambda a: a + 0.25, state.m)
    return {"params": params, "m": m, "v": state.v,
            "count": torch.tensor(4, dtype=torch.int32)}


def test_checkpoint_layout_equals_reference(tmp_path):
    """The same files, keys (sorted-path order) and arrays as the
    reference writes for the same tree."""
    tree = _train_tree(0)
    CheckpointManager(str(tmp_path / "t")).save(3, tree)
    JCheckpointManager(str(tmp_path / "j")).save(
        3, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree))
    for side in ("t", "j"):
        assert sorted(os.listdir(tmp_path / side / "step_00000003")) == [
            "COMMIT", "arrays_p0.npz", "meta.json"]
    import json
    metas = [json.load(open(tmp_path / s / "step_00000003" / "meta.json"))
             for s in ("t", "j")]
    assert metas[0]["keys"] == metas[1]["keys"]
    assert metas[0]["step"] == metas[1]["step"] == 3
    a = np.load(tmp_path / "t" / "step_00000003" / "arrays_p0.npz")
    b = np.load(tmp_path / "j" / "step_00000003" / "arrays_p0.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_float32_checkpoints_cross_between_packages(tmp_path):
    tree = _train_tree(1)
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    CheckpointManager(str(tmp_path / "t")).save(5, tree)
    got = JCheckpointManager(str(tmp_path / "t")).restore(5, jtree)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                         jax.tree_util.tree_leaves(got)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), p
    JCheckpointManager(str(tmp_path / "j")).save(6, jtree)
    like = _train_tree(2)
    back = CheckpointManager(str(tmp_path / "j")).restore(6, like)
    for (p, a), (_, b) in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_bfloat16_checkpoints_cross_between_packages(tmp_path):
    """bf16 params: the port writes the reference's raw ``<V2`` words,
    byte for byte; it restores the reference's bf16 checkpoint exactly;
    the reference's own restore refuses that same file."""
    tree = _train_tree(3, torch.bfloat16)
    jtree = {"params": jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
        tree["params"]),
        **{k: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tree[k]) for k in ("m", "v", "count")}}
    CheckpointManager(str(tmp_path / "t")).save(1, tree)
    JCheckpointManager(str(tmp_path / "j")).save(1, jtree)
    a = np.load(tmp_path / "t" / "step_00000001" / "arrays_p0.npz")
    b = np.load(tmp_path / "j" / "step_00000001" / "arrays_p0.npz")
    for k in b.files:
        assert a[k].dtype == b[k].dtype
        assert a[k].tobytes() == b[k].tobytes(), k
    assert sum(b[k].dtype == np.dtype("V2") for k in b.files) == 3
    like = _train_tree(4, torch.bfloat16)
    back = CheckpointManager(str(tmp_path / "j")).restore(1, like)
    for (p, x), (_, y) in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y), p
    with pytest.raises(TypeError, match="V2"):
        JCheckpointManager(str(tmp_path / "j")).restore(1, jtree)
    with pytest.raises(ValueError, match="only a bfloat16 leaf"):
        CheckpointManager(str(tmp_path / "j")).restore(
            1, _train_tree(4, torch.float32))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        ck.save(step, tree)
    assert ck.all_steps() == [2, 3]
    got = ck.restore(3, tree)
    for (_, x), (_, y) in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(x, y)


def test_checkpoint_ignores_uncommitted(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    tree = {"a": torch.ones(3)}
    ck.save(5, tree)
    os.makedirs(tmp_path / "step_00000009")
    assert ck.latest_step() == 5
    step, _ = ck.restore_latest(tree)
    assert step == 5


def test_checkpoint_async_and_shape_mismatch(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save_async(1, {"a": torch.ones((2, 2))})
    ck.wait()
    with pytest.raises(ValueError):
        ck.restore(1, {"a": torch.ones((3, 3))})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(1, {"b": torch.ones((2, 2))})


def test_checkpoint_async_snapshots_at_the_call(tmp_path):
    """``save_async`` copies at the call: a later in-place change does
    not reach the file, and a write error surfaces on ``wait``."""
    ck = CheckpointManager(str(tmp_path))
    t = torch.zeros(4)
    ck.save_async(2, {"a": t})
    t.add_(1)
    ck.wait()
    assert torch.equal(ck.restore(2, {"a": t})["a"], torch.zeros(4))
    (tmp_path / "blocker").write_text("")
    ck.dir = str(tmp_path / "blocker")   # the write cannot make its dir
    ck.save_async(3, {"a": t})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                            # raised once, then clear


# -------------------------------------------------------------- compression
def test_quantize_and_feedback_equal_reference():
    rng = np.random.default_rng(0)
    residual_t, residual_j = torch.zeros(256), jnp.zeros(256)
    for i in range(5):
        g = rng.standard_normal(256).astype(np.float32) * (i + 1)
        q, s = comp.quantize_int8(torch.from_numpy(g))
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        q, s, residual_t = comp.compress_with_feedback(
            torch.from_numpy(g), residual_t)
        jq, js, residual_j = jcomp.compress_with_feedback(
            jnp.asarray(g), residual_j)
        assert np.array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(residual_t.numpy(),
                                   np.asarray(residual_j), atol=1e-6)
        np.testing.assert_allclose(
            comp.compressed_psum_approx(torch.from_numpy(g)).numpy(),
            np.asarray(jcomp.compressed_psum_approx(jnp.asarray(g))),
            atol=1e-6)


def test_quantize_roundtrip_error_bound():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s = comp.quantize_int8(g)
    assert float((comp.dequantize_int8(q, s) - g).abs().max()) <= \
        float(s) * 0.5 + 1e-7


def test_error_feedback_preserves_sum():
    rng = np.random.default_rng(0)
    residual = torch.zeros(256)
    total_true, total_sent = torch.zeros(256), torch.zeros(256)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        q, s, residual = comp.compress_with_feedback(g, residual)
        total_sent += comp.dequantize_int8(q, s)
        total_true += g
    np.testing.assert_allclose((total_sent + residual).numpy(),
                               total_true.numpy(), atol=1e-3)


def test_apply_compression_tree():
    grads = {"a": torch.ones((8, 8)), "b": torch.full((4,), -2.0)}
    cg, fb = comp.apply_compression(grads, comp.make_feedback_state(grads))
    jg, jfb = jcomp.apply_compression(
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        jcomp.make_feedback_state({k: jnp.asarray(v.numpy())
                                   for k, v in grads.items()}))
    assert sorted(cg) == sorted(grads)
    np.testing.assert_allclose(cg["a"].numpy(), np.ones((8, 8)), atol=0.02)
    for k in grads:
        np.testing.assert_allclose(cg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(fb[k].numpy(), np.asarray(jfb[k]),
                                   atol=1e-6)


# -------------------------------------------------------------- coordinator
def _run(n, fn):
    ts = [threading.Thread(target=fn, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


def test_step_barrier_and_fence():
    c = ClusterCoordinator(4, barrier_timeout_s=10)
    ok = [True] * 4

    def host(r):
        for step in range(15):
            c.heartbeat(r, step)
            if not c.step_barrier(r).ok:
                ok[r] = False
        if not c.checkpoint_fence(r):
            ok[r] = False

    _run(4, host)
    assert all(ok)


def test_straggler_attribution_on_timeout():
    c = ClusterCoordinator(3, barrier_timeout_s=0.3)
    outcomes = {}

    def host(r):
        outcomes[r] = c.step_barrier(r)

    _run(2, host)
    assert not outcomes[0].ok
    assert outcomes[0].stragglers == [2]


def test_heartbeat_stragglers():
    c = ClusterCoordinator(4, heartbeat_lag_steps=2)
    for r in range(4):
        c.heartbeat(r, 10)
    c.heartbeat(3, 3)
    assert c.stragglers() == [3]


def test_membership_evict_join():
    c = ClusterCoordinator(4)
    v0 = c.view()
    assert v0.world_size == 4
    v1 = c.evict(2)
    assert v1.alive == [0, 1, 3] and v1.epoch == v0.epoch + 1
    v2 = c.join(2)
    assert v2.alive == [0, 1, 2, 3] and v2.epoch == v1.epoch + 1


def test_kv_coordinator_barrier():
    kv = InMemoryKV()
    coords = [KVCoordinator(kv, 3, r) for r in range(3)]
    outs = [None] * 3

    def host(r):
        outs[r] = coords[r].barrier(timeout_s=10)

    _run(3, host)
    assert all(o.ok for o in outs)


def test_kv_coordinator_straggler():
    kv = InMemoryKV()
    coords = [KVCoordinator(kv, 3, r, barrier_timeout_s=0.3)
              for r in range(3)]
    outs = {}

    def host(r):
        outs[r] = coords[r].barrier()

    _run(2, host)
    assert not outs[0].ok and outs[0].stragglers == [2]
    coords[0].heartbeat(5)
    assert coords[1].read_heartbeats()[0] == 5
