"""The port's tracing (``core/spans.py``) on the CPU: the serving round's
phase clock and lane counter in ``SlotServeEngine.stats()``, the
``serve.*`` and ``model.*`` ranges on the ``torch.profiler`` timeline,
and the benchmark's readers of those counters (``bench/metrics``).

The host phases must tile ``step``; a profiler must change nothing the
engine serves; with no profiler recording, no ``record_function`` may be
entered. On the CPU the device spans read the host clock at the same
marks the card's CUDA events take."""

import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_arch
from repro_torch.core.spans import PhaseClock, span
from repro_torch.models import build_model
from repro_torch.serve.engine import SlotServeEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PHASES = ("prep", "dispatch", "fetch", "post")
DEVICE_SPANS = ("decode", "prefill", "dispatch")
CHUNK = 4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(arch):
    m = build_model(get_arch(arch).reduced())
    return m, m.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def dense():
    return _model("qwen3-14b")


@pytest.fixture(scope="module")
def moe():
    return _model("olmoe-1b-7b")


def _engine(mp, bucketed="auto", capacity=4):
    m, p = mp
    return SlotServeEngine(m, p, capacity=capacity, max_len=40,
                           kv_layout="paged", page_size=4,
                           prefill_chunk_tokens=CHUNK, decode_chunk=2,
                           attention_impl="fused",
                           bucketed_dispatch=bucketed, device="cpu")


def _submit(eng, seed=3, n=6):
    rng = np.random.default_rng(seed)
    return [eng.submit(rng.integers(0, 512, int(rng.integers(3, 15))
                                    ).astype(np.int32),
                       int(rng.integers(2, 7))) for _ in range(n)]


def _drain(eng):
    """Every round of the engine's work; the wall seconds spent in
    ``step`` calls."""
    wall = 0.0
    while eng.queue or eng.active:
        t0 = time.perf_counter()
        eng.step()
        wall += time.perf_counter() - t0
    return wall


def test_span_is_a_shared_no_op_without_a_profiler():
    assert span("serve.x") is span("model.y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("serve.x"), record_function)


@pytest.mark.parametrize("bucketed", ["on", "off"])
def test_host_phases_tile_the_step(dense, bucketed):
    eng = _engine(dense, bucketed)
    _submit(eng)
    wall = _drain(eng)
    st = eng.stats()
    phases = [st[f"span_{k}_s"] for k in PHASES]
    assert all(v >= 0 for v in phases)
    assert abs(sum(phases) - wall) <= 0.05 * wall
    dev = {k: st[f"span_{k}_device_s"] for k in DEVICE_SPANS}
    assert all(v > 0 for v in dev.values())
    # the decode scan and the chunk lie inside the dispatch's marks, and
    # on the CPU those marks lie inside the host's dispatch phase
    assert dev["decode"] + dev["prefill"] <= dev["dispatch"]
    assert dev["dispatch"] <= st["span_dispatch_s"]


def test_phase_clock_switches_and_marks():
    clock = PhaseClock("cpu", ("a", "b"), {"x": ("x0", "x1")}, "t.")
    t0 = time.perf_counter()
    clock.begin("a")
    time.sleep(0.002)
    clock.switch("b")
    clock.start_marks()
    clock.mark("x0")
    time.sleep(0.002)
    clock.mark("x1")
    clock.read_marks()
    clock.end()
    wall = time.perf_counter() - t0
    assert clock.host_s["a"] >= 0.002 and clock.host_s["b"] >= 0.002
    assert sum(clock.host_s.values()) <= wall
    assert 0.002 <= clock.device_s["x"] <= clock.host_s["b"]
    clock.start_marks()             # an attempt that never read its marks
    clock.mark("x0")
    clock.start_marks()
    clock.read_marks()
    assert 0.002 <= clock.device_s["x"] <= clock.host_s["b"]


@pytest.mark.parametrize("bucketed", ["on", "off"])
def test_prefill_lanes_computed(dense, bucketed, monkeypatch):
    """Three prompts of 10 tokens are three chunk rounds over a bucket of
    4 rows (bucketing on) or all 8 rows (off); a mixed run counts every
    lane the model's chunk calls computed."""
    m, _ = dense
    eng = _engine(dense, bucketed, capacity=8)
    for i in range(3):
        eng.submit(np.arange(1 + i, 11 + i, dtype=np.int32), 3)
    eng.run_until_done()
    st = eng.stats()
    rows = 4 if bucketed == "on" else 8
    assert st["prefill_lanes_computed"] == 3 * rows * CHUNK
    assert st["prefill_tokens"] == 30

    shapes = []
    orig = m.prefill_chunk

    def counted(params, cache, tokens, *rest):
        shapes.append(tuple(tokens.shape))
        return orig(params, cache, tokens, *rest)

    monkeypatch.setattr(m, "prefill_chunk", counted)
    eng = _engine(dense, bucketed)
    _submit(eng)
    eng.run_until_done()
    st = eng.stats()
    assert shapes and all(c == CHUNK for _, c in shapes)
    if bucketed == "off":
        assert all(r == 4 for r, _ in shapes)
    else:
        assert {r for r, _ in shapes} <= {1, 2, 4}
    assert st["prefill_lanes_computed"] == sum(r * c for r, c in shapes)
    assert st["prefill_lanes_computed"] >= st["prefill_tokens"]


def _served(eng, hs):
    st = eng.stats()
    return ({h.rid: list(h.out_tokens) for h in hs}, list(eng.grant_log),
            eng.pool.pages.lock_stats()["acquires"],
            {k: v for k, v in st.items() if not k.endswith("_s")})


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_a_profiler_changes_nothing_served(request, arch):
    mp = request.getfixturevalue(arch)
    outs = []
    for profiled in (False, True):
        eng = _engine(mp)
        hs = _submit(eng)
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()):
            eng.run_until_done()
        outs.append(_served(eng, hs))
    assert outs[1] == outs[0]
    assert outs[0][3]["prefill_lanes_computed"] > 0


def test_no_range_is_entered_without_a_profiler(dense, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    eng = _engine(dense)
    _submit(eng)
    eng.run_until_done()
    assert entered == []
    eng = _engine(dense)
    _submit(eng)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run_until_done()
    assert {"serve.prep", "serve.post", "model.decode_step"} <= set(entered)


def _intervals(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e["name"] == name]


def _inside(iv, outer, eps=1e-3):
    return any(a - eps <= iv[0] and iv[1] <= b + eps for a, b in outer)


@pytest.mark.parametrize("arch, ffn", [("dense", "model.ffn"),
                                       ("moe", "model.moe")])
def test_profiler_trace_nests_the_spans(request, tmp_path, arch, ffn):
    eng = _engine(request.getfixturevalue(arch))
    _submit(eng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        while eng.queue or eng.active:
            with record_function("caller.round"):
                eng.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    rounds = _intervals(events, "caller.round")
    serve = ["serve.prep", "serve.admit", "serve.pages", "serve.dispatch",
             "serve.bucket", "serve.fetch", "serve.post", "serve.retire"]
    model = ["model.decode_step", "model.prefill_chunk", "model.unembed",
             "model.attention", ffn]
    for name in serve + model:
        ivs = _intervals(events, name)
        assert ivs, name
        assert all(_inside(iv, rounds) for iv in ivs), name
    dispatch = _intervals(events, "serve.dispatch")
    for name in model + ["serve.bucket"]:
        assert all(_inside(iv, dispatch) for iv in _intervals(events, name))
    for child, parent in (("serve.admit", "serve.prep"),
                          ("serve.pages", "serve.prep"),
                          ("serve.retire", "serve.post")):
        outer = _intervals(events, parent)
        assert all(_inside(iv, outer) for iv in _intervals(events, child))
    # the four phases follow each other inside a round, prep first
    for a, b in rounds:
        starts = {n: [s for s, _ in _intervals(events, f"serve.{n}")
                      if a <= s <= b] for n in PHASES}
        if starts["dispatch"]:
            assert (min(starts["prep"]) <= min(starts["dispatch"])
                    <= min(starts["fetch"]) <= min(starts["post"]))


# ------------------------------------------------------ benchmark readers
def _ctx(stats_open, stats_close):
    """A window of rounds 2..5 (ended at 3..6 s); round 3 advanced the
    prefill chunks."""
    from bench.drive import Rounds

    rounds = Rounds(SimpleNamespace(step=None))
    rounds.t1 = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    rounds.t0 = [t - 0.5 for t in rounds.t1]
    rounds.chunks = [0, 1, 1, 2, 2, 2, 3]
    run = SimpleNamespace(rounds=rounds, t_open=2.0, t_close=6.0,
                          stats_open=stats_open, stats_close=stats_close)
    return SimpleNamespace(run=run, trace=None)


OPEN = {"span_prep_s": 1.0, "span_post_s": 0.5, "span_dispatch_s": 2.0,
        "span_decode_device_s": 1.0, "span_prefill_device_s": 0.25,
        "prefill_tokens": 100.0, "prefill_lanes_computed": 1024.0}
CHANGE = {"span_prep_s": 0.02, "span_post_s": 0.006,
          "span_dispatch_s": 0.4, "span_decode_device_s": 0.3,
          "span_prefill_device_s": 1.25, "prefill_tokens": 30.0,
          "prefill_lanes_computed": 1536.0}
READERS = {
    "sched_host_ms": 1e3 * 0.026 / 4,
    "dispatch_host_ms": 1e3 * 0.4 / 4,
    "decode_span_ms": 1e3 * 0.3 / 4,
    "prefill_span_ms": 1e3 * 1.25 / 1,
    "prefill_lane_useful_share": 100.0 * 30 / 1536,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_bench_reader_reads_the_window(name):
    from bench.run import read_metric

    close = {k: v + CHANGE[k] for k, v in OPEN.items()}
    got = read_metric(ROOT, name, _ctx(dict(OPEN), close))
    assert got == pytest.approx(READERS[name], rel=1e-9)
    # a program without the counters (the parent's) reads nothing
    assert read_metric(ROOT, name, _ctx({"tokens": 1.0},
                                        {"tokens": 2.0})) is None
