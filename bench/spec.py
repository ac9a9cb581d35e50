"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
one file per configuration (``bench/configs/<config>.json``), per
traffic mix (``bench/mixes/<traffic>.json``) and per cell
(``bench/cells/<workload>.json``: the rate an open-loop cell offers and
the limit of its output check). A new cell, mix or configuration is a
new file and a new entry in ``BENCHMARK.json``; nothing here names one.

A configuration file states the model as it is run, in the published
``config.json`` keys where the model has one (``hidden_size``,
``num_hidden_layers`` ...), plus ``arch``: the architecture of the port
it runs through (``repro_torch.configs``), whose block the file's sizes
are applied to.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: published key -> the port's ``ArchConfig`` field
ARCH_FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "qk_norm": "qk_norm",
    "torch_dtype": "param_dtype",
}

#: published ``hidden_act`` -> the port's FFN (``silu``: the gated SwiGLU)
ACTIVATIONS = {"relu2": "relu2", "silu": "swiglu"}


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    cell: Dict[str, Any]
    run_seconds: int
    end_to_end: list
    per_layer: list

    def e2e_names(self):
        return [m["name"] for m in self.end_to_end
                if self.name in m.get("workloads", [self.name])]

    def per_layer_names(self):
        return [m["name"] for m in self.per_layer
                if self.name in m.get("workloads", [self.name])]


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Optional[Path] = None) -> Dict[str, Any]:
    return _read(Path(root or ROOT) / "BENCHMARK.json")


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration,
    mix and cell files. Raises ``KeyError`` for an unknown name."""
    root = Path(root or ROOT)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell_path = root / "bench" / "cells" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read(root / conf["file"]),
        mix=_read(root / "bench" / "mixes" / f"{w['traffic']}.json"),
        cell=_read(cell_path) if cell_path.is_file() else {},
        run_seconds=int(bench["run_seconds"]),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def arch_config(config: Dict[str, Any]):
    """The port's ``ArchConfig`` for a configuration file: the named
    architecture with the file's sizes applied (imports the program)."""
    from repro_torch.configs import MoEConfig, get_arch

    base = get_arch(config["arch"])
    fields = {ARCH_FIELDS[k]: v for k, v in config.items()
              if k in ARCH_FIELDS}
    fields["activation"] = ACTIVATIONS[config["hidden_act"]]
    if config.get("num_experts"):
        fields["moe"] = MoEConfig(
            num_experts=int(config["num_experts"]),
            top_k=int(config["num_experts_per_tok"]),
            capacity_factor=float(config["capacity_factor"]))
    return dataclasses.replace(base, name=config.get("name", base.name),
                               **fields)


def dims(config: Dict[str, Any]) -> Dict[str, Any]:
    """The sizes the reference and the arithmetic read, by one set of
    short names (no program import)."""
    d = int(config["hidden_size"])
    h = int(config["num_attention_heads"])
    return {
        "layers": int(config["num_hidden_layers"]),
        "d": d, "heads": h,
        "kv_heads": int(config["num_key_value_heads"]),
        "hd": int(config.get("head_dim") or d // h),
        "ff": int(config["intermediate_size"]),
        "vocab": int(config["vocab_size"]),
        "experts": int(config.get("num_experts") or 0),
        "top_k": int(config.get("num_experts_per_tok") or 0),
        "capacity_factor": float(config.get("capacity_factor") or 0.0),
        "activation": ACTIVATIONS[config["hidden_act"]],
        "qk_norm": bool(config.get("qk_norm", False)),
        "tied": bool(config["tie_word_embeddings"]),
        "rope_theta": float(config["rope_theta"]),
        "eps": float(config.get("rms_norm_eps", config.get("norm_eps"))),
        "dtype": config["torch_dtype"],
    }


def scratch_dir() -> Path:
    """Where a run may write (a traced run's trace): the ``TMPDIR`` the
    run is given, else ``build/bench`` inside the checkout."""
    tmp = os.environ.get("TMPDIR")
    path = Path(tmp) / "bench" if tmp else ROOT / "build" / "bench"
    path.mkdir(parents=True, exist_ok=True)
    return path
