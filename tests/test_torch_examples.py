"""The port's example twins (``repro_torch.examples.serve_lm`` and
``serve_stream``) against the repository's ``examples/serve_lm.py`` and
``examples/serve_stream.py``: each pair runs at its defaults (the twin
with ``--device cpu``) in a fresh interpreter, exits 0 (every assert of
the example held), and prints the same ``[example]`` verdict lines — the
FIFO round-trip of 12 requests over 4 slots, and one finished and one
cancelled stream over the same number of dispatches with the page arena
full again. Without a card the twins refuse to run unless asked for the
CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _verdicts(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return [line for line in out.stdout.splitlines()
            if line.startswith("[example]")]


@pytest.mark.parametrize("name", ["serve_lm", "serve_stream"])
def test_twin_prints_the_reference_verdicts(name):
    want = _verdicts([f"examples/{name}.py"])
    got = _verdicts(["-m", f"repro_torch.examples.{name}", "--device",
                     "cpu"])
    assert want and got == want


@pytest.mark.parametrize("name", ["serve_lm", "serve_stream"])
def test_twin_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
