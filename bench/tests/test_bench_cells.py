"""Reduced cells end to end on the CPU: the result line's keys, the
imports, a cell added by files alone, and the check's faults."""

import json
import subprocess
import sys

import pytest
import torch

from bench.tests import tiny

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["dense.closed", "moe.closed",
                                      "dense.open", "moe.open"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, workload, trace):
    res = tiny.run(root, workload, trace=trace)
    keys = CONTRACT_KEYS + (["breakdown"] if "breakdown" in res else [])
    assert list(res) == keys + ["checks"]
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = json.loads((root / "BENCHMARK.json").read_text())
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in cell[group]
            if workload in m.get("workloads", [workload])}
    # the CPU has no device trace: those readers return nothing
    cpu_silent = {"device_idle_share.closed", "device_idle_share.open",
                  "paged_decode_roofline"}
    assert set(res["metrics"]) == want - cpu_silent
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    assert list(res["checks"]) == ["max_gap", "wrong_length"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_seed_fixes_what_is_served(root):
    a = tiny.run(root, "dense.open", seed=8)
    b = tiny.run(root, "dense.open", seed=8)
    assert a["attempted"] == b["attempted"]


SNIPPET = """
import sys
from bench.run import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


def _cli(cwd, *args, env_src=True):
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tiny.ROOT / "src") if env_src else ""
    return subprocess.run([sys.executable, "-c", SNIPPET, *args], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=240)


def test_no_jax_or_reference_package_is_loaded(tmp_path):
    root = tiny.make_root(tmp_path, copy_package=True)
    check = SNIPPET.replace(
        "sys.exit(main(sys.argv[1:], device=\"cpu\"))",
        "rc = main(sys.argv[1:], device='cpu')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print('TOP', sorted(top & {'jax', 'jaxlib', 'flax', 'repro'}))\n"
        "print('TORCH', 'repro_torch' in top)\n"
        "sys.exit(rc)")
    import os
    env = dict(os.environ, PYTHONPATH=str(tiny.ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", check, "--workload",
                        "moe.open", "--seed", "3", "--seconds", "1.5"],
                       cwd=root, capture_output=True, text=True, env=env,
                       timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "TOP []" in p.stdout and "TORCH True" in p.stdout


def test_sources_import_no_jax_reference_or_old_benchmarks():
    import ast
    bad = []
    for path in (tiny.ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "repro", "benchmarks"):
                    bad.append((path.name, n))
                if "reference" in path.parts and top == "repro_torch":
                    bad.append((path.name, n))
    assert not bad


def test_no_card_no_result(tmp_path):
    root = tiny.make_root(tmp_path, copy_package=True)
    p = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        "dense.closed", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=240)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and not p.stdout.strip()


def test_only_benchmark_files_is_not_enough(tmp_path):
    # a directory with BENCHMARK.json and bench/ alone has no program
    root = tiny.make_root(tmp_path, copy_package=True)
    p = _cli(root, "--workload", "dense.closed", "--seed", "1",
             "--seconds", "1", env_src=False)
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, mix, cell and per-layer metric: new files
    and new entries in BENCHMARK.json, no file of bench/ edited."""
    root = tiny.make_root(tmp_path, copy_package=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    conf = json.loads((root / "bench/configs/dense.json").read_text())
    conf.update(hidden_size=32, num_attention_heads=2, num_key_value_heads=1)
    (root / "bench/configs/narrow.json").write_text(json.dumps(conf))
    mix = json.loads((root / "bench/mixes/closed.json").read_text())
    mix.update(clients=3, prompt_tokens=[4, 9], output_tokens=[3, 7])
    (root / "bench/mixes/short.json").write_text(json.dumps(mix))
    (root / "bench/cells/narrow.short.json").write_text(
        json.dumps({"max_gap": 1e-3}))
    (root / "bench/metrics/decode_rows.py").write_text(
        "def read(ctx):\n"
        "    lens = list(ctx.run.decode_lengths.values())\n"
        "    return sum(map(len, lens)) / len(lens) if lens else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "narrow", "source": "tiny",
                         "file": "bench/configs/narrow.json",
                         "reduced": [], "why": "tiny"})
    b["workloads"].append({"name": "narrow.short", "config": "narrow",
                           "traffic": "short", "chips": 1, "why": "tiny"})
    for m in b["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("narrow.short")
    b["per_layer"].append({"name": "decode_rows", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler round",
                           "moves": "output_tokens_per_s",
                           "workloads": ["narrow.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for trace, key in (("0", "output_tokens_per_s"), ("1", "decode_rows")):
        p = _cli(root, "--workload", "narrow.short", "--seed", "2",
                 "--seconds", "1.5", "--trace", trace)
        assert p.returncode == 0, p.stderr[-2000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and key in res["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("workload", ["dense.closed", "moe.open"])
def test_program_state_is_freed_before_the_reference(root, monkeypatch,
                                                      workload):
    """The engine (and its KV arena) is gone when the reference runs."""
    import gc
    import weakref

    from bench import check, run as bench_run

    made, seen = [], []
    orig_make, orig_judge = bench_run.make_engine, check.judge

    def make_engine(*a, **k):
        eng = orig_make(*a, **k)
        made.append(weakref.ref(eng))
        return eng

    def judge(*a, **k):
        gc.collect()
        seen.append(made[0]() is None)
        return orig_judge(*a, **k)

    monkeypatch.setattr(bench_run, "make_engine", make_engine)
    monkeypatch.setattr(check, "judge", judge)
    tiny.run(root, workload, trace=True)
    assert seen == [True]
