"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro`` (checked in a
fresh interpreter and by an AST scan), and the entry points refuse to
run without a card unless they are asked for the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import joined a group'\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "print(' '.join(sorted(sys.modules)))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().split("\n")
    assert int(count) > 20
    # the serving path's modules, the slot arena and the legacy engine
    # among them, were imported by the walk and pulled in neither
    for mod in ("repro_torch.serve.kv_slots", "repro_torch.serve.engine",
                "repro_torch.serve.prefix_cache",
                "repro_torch.serve.scheduler", "repro_torch.launch.serve",
                "repro_torch.serve.faults", "repro_torch.serve.frontend",
                "repro_torch.serve.fuzz",
                "repro_torch.models.attention", "repro_torch.models.lm",
                "repro_torch.models.moe", "repro_torch.models.model_zoo",
                "repro_torch.models.mamba",
                "repro_torch.benchmarks.servebench",
                "repro_torch.benchmarks.hostbench",
                "repro_torch.benchmarks.run", "repro_torch.models.encdec",
                "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
                "repro_torch.launch.train", "repro_torch.core.coordinator",
                "repro_torch.core.memsim", "repro_torch.core.primitives_sim",
                "repro_torch.core.hostbench_probe",
                "repro_torch.benchmarks.membench",
                "repro_torch.examples.sync_primitives",
                "repro_torch.examples.quickstart",
                "repro_torch.sharding.rules", "repro_torch.sharding.act",
                "repro_torch.launch.mesh", "repro_torch.core.device_barrier",
                "repro_torch.train.elastic", "repro_torch.launch.dryrun",
                "repro_torch.analysis.roofline",
                "repro_torch.analysis.step_stats",
                "repro_torch.benchmarks.roofline_report"):
        assert mod in names.split(), mod


@pytest.mark.parametrize("module", [
    "repro_torch.serve.faults", "repro_torch.serve.frontend",
    "repro_torch.serve.fuzz", "repro_torch.launch.serve"])
def test_lifecycle_modules_load_neither_jax_nor_repro(module):
    """Each module of the request lifecycle, imported alone in a fresh
    interpreter, leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.models.mamba", "repro_torch.examples.serve_lm",
    "repro_torch.examples.serve_stream"])
def test_recurrent_slice_modules_load_neither_jax_nor_repro(module):
    """The mamba block and the example twins, each imported alone in a
    fresh interpreter, leave ``jax`` and ``repro`` out of
    ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.benchmarks.servebench", "repro_torch.benchmarks.hostbench",
    "repro_torch.benchmarks.run"])
def test_benchmark_modules_load_neither_jax_nor_repro(module):
    """Each benchmark twin, imported alone in a fresh interpreter, leaves
    ``jax`` and ``repro`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.models.encdec", "repro_torch.train.optimizer",
    "repro_torch.train.train_loop", "repro_torch.train.data",
    "repro_torch.train.checkpoint", "repro_torch.train.compression",
    "repro_torch.core.coordinator", "repro_torch.launch.train",
    "repro_torch.examples.train_lm"])
def test_training_slice_modules_load_neither_jax_nor_repro(module):
    """The encoder-decoder, the training substrate, the coordinator and
    the training entry points, each imported alone in a fresh
    interpreter, leave ``jax`` and ``repro`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.core.memsim", "repro_torch.core.primitives_sim",
    "repro_torch.core.hostbench_probe", "repro_torch.benchmarks.membench",
    "repro_torch.benchmarks.primitives",
    "repro_torch.examples.sync_primitives",
    "repro_torch.examples.quickstart"])
def test_paper_slice_modules_load_neither_jax_nor_repro(module):
    """The simulators, the host probe, the paper-table benchmarks and
    the two example twins, each imported alone in a fresh interpreter,
    leave ``jax`` and ``repro`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.sharding.act", "repro_torch.launch.mesh",
    "repro_torch.core.device_barrier", "repro_torch.train.elastic",
    "repro_torch.train.compression", "repro_torch.models.attention"])
def test_mesh_slice_modules_load_neither_jax_nor_repro(module):
    """The sharding rules and activation policy, the mesh builders and
    world launcher, the device barrier and all-reduces, elastic shapes
    and the head plans, each imported alone in a fresh interpreter,
    leave ``jax`` and ``repro`` out of ``sys.modules``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_resolve_device_refuses_the_cpu_by_default():
    _no_card()
    from repro_torch.core.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_serve_cli_refuses_the_cpu_by_default():
    _no_card()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--requests", "1"])


@pytest.mark.parametrize("flags", [
    ["--legacy"], ["--kv-layout", "paged"],
    ["--kv-layout", "slots", "--prefill-chunk-tokens", "4"],
    ["--kv-layout", "paged", "--prefix-sharing", "on", "--prefix-cache",
     "on"]],
    ids=["legacy", "paged", "slots-chunked", "paged-prefix"])
def test_serve_cli_paths_refuse_the_cpu_by_default(flags):
    _no_card()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-14b", "--smoke", "--requests", "1",
                    *flags])


def test_servebench_refuses_the_cpu_by_default():
    _no_card()
    from repro_torch.benchmarks import servebench
    with pytest.raises(RuntimeError, match="no CUDA device"):
        servebench.main(["--smoke", "--requests", "1", "--out", ""])


def test_slot_arena_refuses_the_cpu_by_default():
    _no_card()
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve.kv_slots import SlotPool
    model = build_model(get_arch("qwen3-14b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotPool(model, 2, 8)


def test_serve_cli_default_invocation_runs_on_the_cpu(capsys):
    """The reference launcher's default invocation (the contiguous slot
    arena, one-shot prefill, decode chunk 2) with the legacy loop's
    comparison, on the CPU because it is asked for."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                      "--requests", "12", "--capacity", "4",
                      "--prompt-len", "16", "--new-tokens", "8",
                      "--legacy"])
    out = capsys.readouterr().out
    assert eng.kv_layout == "slots" and eng.prefill_chunk == 0
    assert eng.decode_chunk == 2
    assert "slots engine: 12 requests, 96 tokens" in out
    assert "FIFO grant order: OK" in out
    assert "legacy loop: 96 tokens" in out and "speedup" in out
    assert eng.grant_log == list(range(12))


def test_serve_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen3-14b", "--smoke", "--requests", "4",
                      "--capacity", "2", "--prompt-len", "6",
                      "--new-tokens", "3", "--kv-layout", "paged",
                      "--page-size", "4", "--prefill-chunk-tokens", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "FIFO grant order: OK" in out and "leak check: OK" in out
    assert eng.grant_log == [0, 1, 2, 3]
    assert all(len(r.out_tokens) == 3 for r in eng.finished)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run([sys.executable, str(SMOKE)], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result (with or without a
    card)."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("prefill", [["--prefill-chunk-tokens", "4"], []],
                         ids=["chunked", "one-shot"])
def test_serve_cli_prefix_sharing_and_cache_run_on_the_cpu(capsys, prefill):
    """``--prefix-sharing on --prefix-cache on`` on the paged layout,
    on the CPU because it is asked for: the cache's prints, and the
    leak gate passes after the cache is released."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen3-14b", "--smoke", "--requests", "4",
                      "--capacity", "2", "--prompt-len", "9",
                      "--new-tokens", "3", "--kv-layout", "paged",
                      "--page-size", "4", "--prefix-sharing", "on",
                      "--prefix-cache", "on", "--device", "cpu", *prefill])
    out = capsys.readouterr().out
    assert eng.prefix_sharing and eng.prefix_cache is not None
    assert "prefix sharing on:" in out and "prefix cache:" in out
    assert "FIFO grant order: OK" in out and "leak check: OK" in out
    assert eng.prefix_cache.pages_held == 0 and eng.pool.pages.in_use == 0
    assert all(len(r.out_tokens) == 3 for r in eng.finished)


def test_serve_cli_prefix_defaults_are_the_reference_defaults():
    """The launcher's defaults are the reference launcher's
    (``src/repro/launch/serve.py``): sharing ``auto``, the cache
    ``off``, the watermark unset."""
    from repro_torch.launch import serve
    args = serve.parser().parse_args(["--arch", "qwen3-14b"])
    assert (args.prefix_sharing, args.prefix_cache,
            args.cache_watermark) == ("auto", "off", None)
