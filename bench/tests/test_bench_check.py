"""The output check: the control (the reference in float8) fails it, and
so does a run whose timed path is broken underneath. The cells here are
tiny; the full-size readings are in PERF.md."""

import pytest
import torch

from bench.tests import tiny


@pytest.fixture(scope="module")
def root32(tmp_path_factory):
    # float32 weights: sound runs read a gap of 0, any fault reads more
    return tiny.make_root(tmp_path_factory.mktemp("b32"), dtype="float32",
                          limit=1e-3)


@pytest.fixture(scope="module")
def root16(tmp_path_factory):
    # bfloat16: sound runs read up to ~0.015 here, the float8 control
    # 0.09-0.29 (three seeds, CPU)
    return tiny.make_root(tmp_path_factory.mktemp("b16"), dtype="bfloat16",
                          limit=0.04)


@pytest.mark.parametrize("workload", ["dense.closed", "moe.open"])
def test_sound_run_is_correct(root32, workload):
    res = tiny.run(root32, workload, seed=21)
    assert res["correct"] is True
    assert res["checks"]["max_gap"]["value"] <= 1e-3


def test_control_is_not_correct(root16):
    """The float8 control in the bfloat16 program's place, three seeds:
    the run's own comparison finds it not correct, while the program's
    served tokens of the same run stay within the limit."""
    for seed in (11, 12, 13):
        res = tiny.run(root16, "dense.closed", seed=seed, control="fp8")
        assert res["correct"] is False, res["checks"]
        assert res["checks"]["max_gap"]["value"] > 0.04
        assert res["program"]["max_gap"] <= 0.04, res["program"]


def _alter_token(monkeypatch):
    from repro_torch.serve.engine import SlotServeEngine

    orig = SlotServeEngine._dispatch

    def dispatch(self, view, frozen, chunk_rows, steps):
        cache, tok, toks, pf_logits, valid = orig(self, view, frozen,
                                                  chunk_rows, steps)
        rows = [s for s in sorted(self.active) if not frozen[s]]
        if rows:
            s = rows[0]
            toks[:, s] = (toks[:, s] + 1) % self.model.cfg.vocab_size
            tok[s] = toks[-1, s]
        return cache, tok, toks, pf_logits, valid

    monkeypatch.setattr(SlotServeEngine, "_dispatch", dispatch)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "scatter_planned",
                        lambda arena, plan, val: arena)


def _half_batch(monkeypatch):
    from repro_torch.models.lm import LM

    orig = LM.decode_step

    def decode_step(self, params, cache, tok, **kw):
        logits, cache = orig(self, params, cache, tok, **kw)
        b = logits.shape[0]
        if b > 1:
            logits = logits.clone()
            logits[b // 2:] = logits[:b - b // 2]
        return logits, cache

    monkeypatch.setattr(LM, "decode_step", decode_step)


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch"])
@pytest.mark.parametrize("workload", ["dense.closed", "moe.open"])
def test_broken_timed_path_is_not_correct(root32, monkeypatch, fault,
                                          workload):
    fault(monkeypatch)
    res = tiny.run(root32, workload, seed=21)
    assert res["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", ["minitron-4b.reasoning-closed",
                                      "olmoe-1b-7b.reasoning-closed"])
def test_control_fails_at_the_cells_size(workload):
    """On a card: one seed of each cell at its own size and window, the
    control in the program's place. The run's comparison finds it not
    correct, and the program's own tokens of that run within limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from bench import spec
    from bench.run import run_cell

    cell = spec.load_cell(workload)
    res = run_cell(cell, 2 ** 31 + 3, float(cell.run_seconds), False,
                   t_start=time.perf_counter(), control="fp8")
    assert res["correct"] is False, res["checks"]
    for k, c in res["checks"].items():
        if k in res["program"]:
            assert res["program"][k] <= c["limit"], (k, res["program"])
