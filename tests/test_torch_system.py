"""End to end through the port: train -> async checkpoint -> crash ->
resume -> serve, with the control plane in the loop — the twin of
tests/test_system.py, first through the port alone, then against the
reference's own run on the same weights and data — and the training
entry points: ``repro_torch.launch.train`` (every flag of the
reference's, a crash between checkpoints and ``--resume``, the
refusals) and the ``examples/train_lm.py`` twin.

Reduced gemma3-1b (five local layers with a window of 8 and one global),
float32 on the CPU. The resumed run must land where the crashed run did
within the reference test's atol 1e-5 / rtol 1e-4 (on the CPU it lands
exactly); against the reference, losses within 1e-5 x max(1, |loss|),
params within 1e-5 but where Adam amplified float32 noise
(``test_torch_train.adam_close``), and the greedy streams served from
the trained weights equal."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import optimizer as jopt
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.coordinator import ClusterCoordinator
from repro_torch.examples import train_lm
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticLM
from repro_torch.train.train_loop import make_train_step
from test_torch_train import adam_close

OCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny reduced models gain nothing from intra-op threads, and the
    suite's workers share the CPU: one thread each keeps this module's
    runs from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _same_leaves(a, b):
    """{path: (leaf of a, leaf of b)}; the trees hold the same paths."""
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(la) == sorted(lb)
    return {p: (la[p], lb[p]) for p in la}


def _close(a, b):
    for p, (x, y) in _same_leaves(a, b).items():
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=p)


@pytest.fixture(scope="module")
def gemma():
    jm = jbuild(jget_arch("gemma3-1b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("gemma3-1b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def crash_run(gemma, tmp_path_factory):
    """Phase 1 of the reference test through the port: 6 steps from the
    bridged weights, an async checkpoint after step 3 behind the fence,
    then the "crash". Returns (params at the crash, the losses, the
    checkpoint directory, the step function)."""
    _, _, tm, tp = gemma
    step_fn = make_train_step(tm, opt.AdamWConfig(**OCFG),
                              num_microbatches=1, remat=True)
    coord = ClusterCoordinator(world=1, barrier_timeout_s=10)
    d = str(tmp_path_factory.mktemp("ckpt"))
    ck = CheckpointManager(d, keep_n=2)
    params, state = tp, opt.init(opt.AdamWConfig(**OCFG), tp)
    ds = SyntheticLM(512, 2, 24, seed=7)
    losses = []
    for step in range(6):
        params, state, met = step_fn(params, state, _batch(next(ds)))
        losses.append(float(met["loss"]))
        coord.heartbeat(0, step)
        if step == 3:
            assert coord.checkpoint_fence(0)
            ck.save_async(step, {"params": params, "m": state.m,
                                 "v": state.v, "count": state.count})
    ck.wait()
    return params, losses, d, step_fn


def test_train_checkpoint_crash_resume_serve(gemma, crash_run):
    _, _, tm, _ = gemma
    params_at_crash, losses, d, step_fn = crash_run
    ck = CheckpointManager(d, keep_n=2)
    fresh = tm.init(torch.Generator().manual_seed(1), "cpu")
    state2 = opt.init(opt.AdamWConfig(**OCFG), fresh)
    assert ck.latest_step() == 3
    tree = ck.restore(3, {"params": fresh, "m": state2.m, "v": state2.v,
                          "count": state2.count})
    params2 = tree["params"]
    state2 = opt.AdamWState(count=tree["count"], m=tree["m"], v=tree["v"])
    assert int(state2.count) == 4
    ds2 = SyntheticLM(512, 2, 24, seed=7, start_step=4)
    for _ in range(4, 6):
        params2, state2, _ = step_fn(params2, state2, _batch(next(ds2)))
    _close(params_at_crash, params2)
    assert all(torch.equal(a, b) for a, b in _same_leaves(
        params_at_crash, params2).values())
    assert losses[-1] < losses[0]
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 8)).astype(np.int32))
    out = ServeEngine(tm, params2, max_len=32).generate({"tokens": prompts},
                                                       n_tokens=4)
    assert out.tokens.shape == (2, 4)


def test_system_run_equals_the_reference(gemma, crash_run):
    """The reference's phase 1 on the same weights and stream: losses and
    the crashed params within tolerance, then the greedy streams served
    from each package's trained weights equal."""
    jm, jp, tm, _ = gemma
    params_at_crash, losses, _, _ = crash_run
    jstep = jax.jit(jmake_train_step(jm, jopt.AdamWConfig(**OCFG),
                                     num_microbatches=1, remat=True))
    js = jopt.init(jopt.AdamWConfig(**OCFG), jp)
    ds = JSyntheticLM(512, 2, 24, seed=7)
    jlosses = []
    for _ in range(6):
        jp, js, met = jstep(jp, js, {k: jnp.asarray(v)
                                     for k, v in next(ds).items()})
        jlosses.append(float(met["loss"]))
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b))
    want = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    lr_sum = sum(float(jopt.schedule(jopt.AdamWConfig(**OCFG),
                                     jnp.asarray(t))) for t in range(1, 7))
    for p, x in tree_leaves(params_at_crash):
        adam_close(x.numpy(), want[p], lr_sum, p)
    prompts = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(
        np.int32)
    jout = JServeEngine(jm, jp, max_len=32).generate(
        {"tokens": jnp.asarray(prompts)}, n_tokens=6)
    tout = ServeEngine(tm, params_at_crash, max_len=32).generate(
        {"tokens": torch.from_numpy(prompts)}, n_tokens=6)
    assert tout.tokens.tolist() == np.asarray(jout.tokens).tolist()


# ------------------------------------------------------------- entry points
CLI = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps", "6",
       "--batch", "2", "--seq", "16", "--ckpt-every", "4", "--log-every",
       "2"]


def test_train_cli_resumes_where_the_crash_left_off(tmp_path, capsys):
    """A run of 6 steps checkpoints after step 3 and at its end; with the
    end's checkpoint lost (a crash before it committed) ``--resume``
    restores step 3, replays steps 4-5 of the stream and lands exactly
    where the run did."""
    d = str(tmp_path / "ckpt")
    first = train_cli.main(CLI + ["--ckpt-dir", d])
    assert first["start_step"] == 0 and len(first["losses"]) == 6
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000005"]
    assert all(np.isfinite(first["losses"]))
    shutil.rmtree(os.path.join(d, "step_00000005"))
    again = train_cli.main(CLI + ["--ckpt-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert again["start_step"] == 4 and len(again["losses"]) == 2
    assert again["losses"] == first["losses"][4:]
    for p, (a, b) in _same_leaves(first["params"], again["params"]).items():
        assert torch.equal(a, b), p
    assert int(again["state"].count) == 6


def test_train_cli_flags_are_the_reference_flags():
    """Every flag of the reference launcher, with its default (read from
    the reference's source), plus ``--device``."""
    import ast
    import inspect
    import re

    from repro.launch import train as jtrain
    want = {m.group(1): m.group(2) for m in re.finditer(
        r'add_argument\("(--[a-z-]+)"(?:[^)]*?default=([^,)]+))?',
        inspect.getsource(jtrain.main))}
    args = vars(train_cli.parse_args(["--arch", "x"]))
    got = {"--" + k.replace("_", "-"): v for k, v in args.items()}
    assert len(want) == 12 and set(got) == set(want) | {"--device"}
    for flag, default in want.items():
        if default is not None:
            assert got[flag] == ast.literal_eval(default), flag
    assert got["--device"] == "cuda"


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-76b"])
def test_train_cli_refuses_the_embedding_families(name):
    with pytest.raises(SystemExit, match="token-LM archs"):
        train_cli.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--steps", "1"])


def test_train_cli_refuses_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1"])


def test_train_lm_example_crash_and_resume(tmp_path):
    """The example twin's preset 5m: a crash after step 52 (its last
    checkpoint is step 49's), then ``--resume`` to step 59, lands where
    an uninterrupted run does."""
    common = ["--preset", "5m", "--steps", "60", "--batch", "2", "--seq",
              "16", "--device", "cpu"]
    crashed = train_lm.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                                      "--crash-at", "52"])
    assert crashed["crashed"] and len(crashed["losses"]) == 53
    resumed = train_lm.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                                      "--resume"])
    assert len(resumed["losses"]) == 10 and not resumed["crashed"]
    whole = train_lm.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["losses"] == whole["losses"][50:]
    for p, (a, b) in _same_leaves(whole["params"],
                                  resumed["params"]).items():
        assert torch.equal(a, b), p
    assert whole["losses"][-1] < whole["losses"][0]


def test_train_lm_presets_equal_the_reference():
    """The twin's presets and flags are the reference example's."""
    import dataclasses
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm.py"
    spec = importlib.util.spec_from_file_location("reference_train_lm", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert sorted(train_lm.PRESETS) == sorted(ref.PRESETS)
    for name, cfg in ref.PRESETS.items():
        mine = dataclasses.asdict(train_lm.PRESETS[name])
        assert mine == dataclasses.asdict(cfg), name
    flags = {a.dest for a in train_lm.parser()._actions} - {"help"}
    assert flags == {"preset", "steps", "batch", "seq", "ckpt_dir",
                     "crash_at", "resume", "device"}
