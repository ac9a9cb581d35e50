"""Roofline report: read dry-run records -> per-cell three-term table
(counterpart of ``benchmarks/roofline_report.py``).

Reads ``$DRYRUN_ART/*.json`` (default ``artifacts/dryrun_torch``, written
by ``repro_torch.launch.dryrun``) and emits the roofline table:
compute / memory / collective terms (seconds, on the H100 constants of
``analysis/roofline.py``), the dominant bottleneck, MODEL_FLOPS over
traced flops, and the perfect-overlap MFU bound.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

ART_DIR = os.environ.get("DRYRUN_ART", "artifacts/dryrun_torch")


def load_records(art_dir: Optional[str] = None) -> List[dict]:
    recs = []
    art_dir = art_dir or os.environ.get("DRYRUN_ART", ART_DIR)
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def render_table(recs: List[dict], mesh: Optional[str] = "16x16") -> List[str]:
    rows = []
    header = ("arch,shape,mesh,t_compute_s,t_memory_s,t_collective_s,"
              "bottleneck,useful_flops_ratio,mfu_bound")
    rows.append(header)
    for r in recs:
        if mesh and r["mesh"] != mesh:
            continue
        rows.append(
            f"{r['arch']},{r['shape']},{r['mesh']},"
            f"{r['t_compute']:.4f},{r['t_memory']:.4f},"
            f"{r['t_collective']:.4f},{r['bottleneck']},"
            f"{r['useful_flops_ratio']:.3f},{r['mfu_bound']:.4f}")
    return rows


def pick_hillclimb_candidates(recs: List[dict]) -> Dict[str, dict]:
    """The three tuning targets: worst roofline fraction (a train cell),
    most collective-bound, and most synchronization ops (the largest
    collective *count* — the cell that stresses the paper's
    synchronization scheduling the hardest)."""
    single = [r for r in recs if r["mesh"] == "16x16"]
    if not single:
        return {}
    out = {}
    train = [r for r in single if r["shape"].startswith("train")]
    if train:
        out["worst_roofline"] = min(train, key=lambda r: r["mfu_bound"])
    out["most_collective_bound"] = max(
        single, key=lambda r: r["t_collective"] /
        max(r["t_compute"] + r["t_memory"] + r["t_collective"], 1e-12))
    out["most_sync_ops"] = max(
        single,
        key=lambda r: sum(c["count"] for c in r["collectives"].values()))
    return out


def main() -> List[str]:
    recs = load_records()
    if not recs:
        return ["roofline_report,0.0,no_artifacts_found_run_dryrun_first"]
    out = []
    for line in render_table(recs, mesh=None):
        out.append(f"roofline,{0.0:.1f},{line}")
    cands = pick_hillclimb_candidates(recs)
    for k, r in cands.items():
        out.append(f"roofline_candidate_{k},{0.0:.1f},"
                   f"{r['arch']}/{r['shape']} bottleneck={r['bottleneck']}")
    return out


if __name__ == "__main__":
    for r in main():
        print(r)
