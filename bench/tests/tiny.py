"""A reduced copy of the benchmark for the CPU tests: the repository's
``bench/`` package with tiny configurations (the published files with
their widths and depths cut), tiny mixes (the published mixes with
their sizes cut) and one cell of each (configuration, mix) pair."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "head_dim": 16,
              "vocab_size": 512}


def tiny_configs(dtype: str) -> Dict[str, dict]:
    dense = json.loads((ROOT / "bench/configs/minitron-4b.json").read_text())
    dense.update(TINY_MODEL, num_key_value_heads=2, intermediate_size=128,
                 torch_dtype=dtype)
    moe = json.loads((ROOT / "bench/configs/olmoe-1b-7b.json").read_text())
    moe.update(TINY_MODEL, num_key_value_heads=4, intermediate_size=32,
               num_experts=8, num_experts_per_tok=2, torch_dtype=dtype)
    return {"dense": dense, "moe": moe}


def tiny_mixes() -> Dict[str, dict]:
    closed = json.loads(
        (ROOT / "bench/mixes/reasoning-closed.json").read_text())
    closed.update(clients=5, prompt_tokens=[8, 20], output_tokens=[6, 20],
                  requests_pool=256, trace={"after_s": 0.2, "rounds": 4},
                  check={"requests": 4, "served_tokens": 200})
    closed["engine"].update(capacity=4, max_len=41, page_size=4,
                            prefill_chunk_tokens=8)
    opn = json.loads((ROOT / "bench/mixes/rag-open.json").read_text())
    opn.update(documents=6, document_tokens=32, suffix_tokens=[4, 8],
               output_tokens=[3, 6], warm_s=0.5,
               trace={"after_s": 0.2, "rounds": 4},
               check={"requests": 4, "served_tokens": 100})
    opn["engine"].update(capacity=4, max_len=47, num_pages=160,
                         page_size=4, prefill_chunk_tokens=8)
    return {"closed": closed, "open": opn}


def make_root(tmp: Path, dtype: str = "float32", limit: float = 1e-3,
              copy_package: bool = False) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` naming the four
    tiny cells ``{dense,moe}.{closed,open}`` with the real metric list,
    and ``bench/`` (the real package, copied whole with
    ``copy_package``, else only its data and readers)."""
    tmp = Path(tmp)
    src = ROOT / "bench"
    if copy_package:
        shutil.copytree(src, tmp / "bench", ignore=shutil.ignore_patterns(
            "__pycache__", "tests"))
    else:
        (tmp / "bench").mkdir(parents=True, exist_ok=True)
        shutil.copytree(src / "metrics", tmp / "bench/metrics")
    for d in ("configs", "mixes", "cells"):
        (tmp / "bench" / d).mkdir(parents=True, exist_ok=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs, mixes = tiny_configs(dtype), tiny_mixes()
    names = {"closed": [], "open": []}
    workloads, configs = [], []
    for c, body in cfgs.items():
        (tmp / f"bench/configs/{c}.json").write_text(json.dumps(body))
        configs.append({"name": c, "source": body["source"],
                        "file": f"bench/configs/{c}.json",
                        "reduced": body["reduced"], "why": "tiny"})
        for m in mixes:
            w = f"{c}.{m}"
            names[m].append(w)
            workloads.append({"name": w, "config": c, "traffic": m,
                              "chips": 1, "why": "tiny"})
            cell = {"max_gap": limit}
            if m == "open":
                cell["rate_per_s"] = 8.0
            (tmp / f"bench/cells/{w}.json").write_text(json.dumps(cell))
    for m, body in mixes.items():
        (tmp / f"bench/mixes/{m}.json").write_text(json.dumps(body))
    # the real metrics, their cell lists mapped onto the tiny cells, and
    # the open-loop cells' metrics, whose readers wait in bench/metrics
    # for the open cells (PERF.md, open questions)
    kind = {w["name"]: ("open" if "rag" in w["traffic"] else "closed")
            for w in real["workloads"]}
    for group in ("end_to_end", "per_layer"):
        for m in real[group]:
            if "workloads" in m:
                ks = {kind[w] for w in m["workloads"]}
                m["workloads"] = [w for k in sorted(ks) for w in names[k]]
    real["end_to_end"].append(
        {"name": "ttft_p50_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": names["open"]})
    for name in ("device_idle_share.open", "round_ms.open",
                 "prefill_round_share.open", "queue_wait_p95_ms",
                 "prefill_saved_share"):
        real["per_layer"].append(
            {"name": name, "unit": "%", "better": "lower",
             "source": "program_counter", "layer": "open loop",
             "moves": "ttft_p50_ms", "workloads": names["open"]})
    real.update(configs=configs, workloads=workloads, run_seconds=2)
    (tmp / "BENCHMARK.json").write_text(json.dumps(real, indent=1))
    return tmp


def run(root: Path, workload: str, seed: int = 5, seconds: float = 1.5,
        trace: bool = False, **kw):
    """One tiny run in this process, on the CPU."""
    import time

    from bench import spec
    from bench.run import run_cell

    cell = spec.load_cell(workload, root)
    return run_cell(cell, seed, seconds, trace, device="cpu",
                    t_start=time.perf_counter(), root=root,
                    log=lambda *a, **k: None, **kw)
