"""Paper Tables 1-3: memory-system benchmarks (twin of the repository's
``benchmarks/membench.py``; row names and ``derived`` fields letter for
letter).

Two tiers, labeled in the output:
  simulated — the discrete-event simulator parameterized from Table 1
              replaying the paper's 12 benchmarks on the Tesla/Fermi
              abstractions (``membench_sim_*``, ``membench_ratios_*``);
              plain Python, identical to the reference's on any machine;
  measured  — the same benchmark grid run with real threads on the CPU of
              whatever machine runs it (``membench_host_classify``).

The CUDA membench kernel's cells are in ``kernelbench`` (``kernel_*``).

    python -m repro_torch.benchmarks.membench
    python -m repro_torch.benchmarks.run --section membench
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.core.abstraction import FERMI, TESLA
from repro_torch.core.hostbench_probe import classify_host
from repro_torch.core.memsim import run_membench

PAPER_TABLE1 = {
    # (machine, contentious, atomic, preceded) read/write ms per 1000 acc.
    "tesla": {
        ("vol", "cont"): (0.848, 0.829),
        ("vol", "nonc"): (0.590, 0.226),
        ("atm", "cont"): (78.407, 78.404),
        ("atm", "nonc"): (0.845, 0.991),
        ("vpa", "cont"): (0.923, 0.915),
        ("vpa", "nonc"): (0.601, 0.228),
    },
    "fermi": {
        ("vol", "cont"): (0.494, 0.175),
        ("vol", "nonc"): (0.043, 0.029),
        ("atm", "cont"): (1.479, 1.470),
        ("atm", "nonc"): (0.437, 0.312),
        ("vpa", "cont"): (1.473, 0.824),
        ("vpa", "nonc"): (0.125, 0.050),
    },
}


def run_sim_table1(accesses: int = 200) -> List[str]:
    rows = []
    for m, name in ((TESLA, "tesla"), (FERMI, "fermi")):
        for (kind, cont), (p_read, p_write) in PAPER_TABLE1[name].items():
            atomic = kind == "atm"
            preceded = kind == "vpa"
            for write, paper in ((False, p_read), (True, p_write)):
                t0 = time.perf_counter()
                sim = run_membench(
                    m, atomic=atomic, contentious=(cont == "cont"),
                    write=write, preceded_by_atomic=preceded,
                    accesses=accesses)
                us = (time.perf_counter() - t0) * 1e6
                rows.append(
                    f"membench_sim_{name}_{kind}_{cont}_"
                    f"{'w' if write else 'r'},{us:.1f},"
                    f"sim_ms={sim:.3f};paper_ms={paper:.3f};"
                    f"ratio={sim / paper:.2f}")
    return rows


def run_host_row(threads: int = 8, accesses: int = 5000) -> List[str]:
    t0 = time.perf_counter()
    host = classify_host(threads=threads, accesses=accesses)
    us = (time.perf_counter() - t0) * 1e6
    s = host.summary()
    return [
        f"membench_host_classify,{us:.1f},"
        f"P1={s['P1_atomic_volatile_ratio']:.1f};"
        f"P2={s['P2_contention_ratio']:.2f};"
        f"P3={int(s['P3_line_hostage'])}"
    ]


def run_table2_table3() -> List[str]:
    rows = []
    for m, name in ((TESLA, "tesla"), (FERMI, "fermi")):
        t0 = time.perf_counter()
        # Table 2: contentious:noncontentious; Table 3: x:volatile
        cv = run_membench(m, atomic=False, contentious=True, write=False, accesses=200)
        nv = run_membench(m, atomic=False, contentious=False, write=False, accesses=200)
        ca = run_membench(m, atomic=True, contentious=True, write=False, accesses=200)
        na = run_membench(m, atomic=True, contentious=False, write=False, accesses=200)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(f"membench_ratios_{name},{us:.1f},"
                    f"T2_vol={cv / nv:.2f};T2_atm={ca / na:.2f};"
                    f"T3_cont={ca / cv:.2f};T3_nonc={na / nv:.2f}")
    return rows


def main() -> List[str]:
    rows = run_sim_table1()
    rows += run_table2_table3()
    rows += run_host_row()
    return rows


if __name__ == "__main__":
    for r in main():
        print(r)
