"""The port's twins of ``examples/sync_primitives.py`` and
``examples/quickstart.py`` (``repro_torch.examples.sync_primitives`` and
``quickstart``), run in a fresh interpreter with ``--device cpu``
beside the repository's scripts: each exits 0, and the deterministic
lines — the Tesla, Fermi and TPU rows of the abstraction and selection
tables, Figure 2 at 96 blocks, the Table-5 selection, the simulated ops/s
at 64 blocks, the cross-backend plans and the admission plan — are the
reference's, with its backend names mapped to the port's (``kernel`` ->
``cuda``, ``tpu`` -> ``ref``). Without a card both twins refuse to run
unless asked for the CPU."""

import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIM_MACHINES = ("tesla-gtx295", "fermi-gtx580", "tpu-v5e")


def _run(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["OMP_NUM_THREADS"] = "1"    # pytest may run several workers at once
    out = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def _port_names(line):
    line = line.replace("(kernel,", "(cuda  ,").replace("(tpu   ,",
                                                         "(ref   ,")
    return re.sub(r"on backend kernel$", "on backend cuda", line)


def test_sync_primitives_twin_prints_the_reference_lines():
    want = _run(["examples/sync_primitives.py"])
    got = _run(["-m", "repro_torch.examples.sync_primitives", "--device",
                "cpu"])

    def simulated(lines):
        return [ln for ln in lines
                if ln.strip().startswith(SIM_MACHINES)]

    assert simulated(got) == [_port_names(ln) for ln in simulated(want)]
    assert len(simulated(got)) == 2 + 3 * 3 + 2
    assert any("best: fa" in ln for ln in simulated(got))
    assert any("best: spin_backoff" in ln for ln in simulated(got))
    plans = [ln for ln in got if ln.strip().startswith("semaphore[")]
    assert [ln.split("[")[1][:6].strip() for ln in plans] == ["host", "ref"]
    assert all(ln.endswith("== ref") for ln in plans)
    ref_plans = {ln.split("[")[1][:6].strip(): ln for ln in want
                 if ln.strip().startswith("semaphore[")}
    assert plans == [ref_plans["host"], ref_plans["ref"]]
    # the control plane: the straggler, the eviction, the admission plan
    assert any(ln.startswith("  rank 0 saw stragglers: [3]") for ln in got)
    evict = [ln for ln in got if "evicted rank 3" in ln]
    assert evict == [ln for ln in want if "evicted rank 3" in ln]
    adm = [ln for ln in got if ln.startswith("  24 requests, capacity 6")]
    ref_adm = [ln for ln in want if ln.startswith("  24 requests, capacity 6")]
    assert adm == [ln.replace("[kernel]", "[ref]") for ln in ref_adm]
    host = [ln for ln in got if ln.strip().startswith("host-cpu")]
    assert len(host) == 1 + 3           # abstraction row + three triples
    assert all("(host  ," in ln for ln in host[1:])
    assert got[-1] == "sync_primitives demo done."


def test_quickstart_twin_runs_on_the_cpu():
    want = _run(["examples/quickstart.py"])
    got = _run(["-m", "repro_torch.examples.quickstart", "--device", "cpu"])

    def simulated(lines):
        return [ln for ln in lines
                if ln.strip().startswith(SIM_MACHINES + ("mutex/",))]

    assert simulated(got) == [_port_names(ln) for ln in simulated(want)]
    assert len(simulated(got)) == 6 + 2
    assert "  acquired a SpinMutex and released it" in got
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in got
              if ln.startswith("  step ")]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    (first,) = [ln for ln in got if ln.startswith("  first batch: loss ")]
    before, after = (float(w.rstrip(",")) for w in first.split()[3:6:2])
    assert after < before, first
    assert got[-1] == "quickstart done."


@pytest.mark.parametrize("name", ["sync_primitives", "quickstart"])
def test_twin_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
