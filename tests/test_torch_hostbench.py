"""The host benchmark's twin (``repro_torch.benchmarks.hostbench``) and the
port's ``benchmarks/run.py`` twin: the row names equal the JAX
package's ``benchmarks/hostbench.py`` (loaded by file path) at the same
sizes, every rate is finite and above 0, and each section of the run
entry point prints its rows on the CPU (the primitives section on small
block lists)."""

import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch.benchmarks import hostbench, primitives, run

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_hostbench():
    spec = importlib.util.spec_from_file_location(
        "reference_hostbench", ROOT / "benchmarks" / "hostbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rate(row):
    name, us, derived = row.split(",")
    return float(us), float(derived.split("=")[1])


def test_row_names_equal_the_reference():
    want = _reference_hostbench().main(threads=2, ops=20)
    got = hostbench.main(threads=2, ops=20)
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    assert len(got) == 10
    for row in got:
        us, rate = _rate(row)
        assert math.isfinite(us) and us > 0, row
        assert math.isfinite(rate) and rate > 0, row
    assert [r.split(",")[2].split("=")[0] for r in got] \
        == [r.split(",")[2].split("=")[0] for r in want]


@pytest.mark.parametrize("kind,make", [
    ("mutex", lambda: hostbench.TicketMutex()),
    ("semaphore", lambda: hostbench.SleepingSemaphore(2)),
    ("barrier", hostbench.XFBarrier)])
def test_each_bench_reports_a_positive_rate(kind, make):
    fn = {"mutex": hostbench.bench_mutex,
          "semaphore": hostbench.bench_semaphore,
          "barrier": hostbench.bench_barrier}[kind]
    rate = fn(make, 3, 10)
    assert math.isfinite(rate) and rate > 0


def test_cpu_model_names_the_host_cpu():
    name = hostbench.cpu_model()
    assert isinstance(name, str)
    if pathlib.Path("/proc/cpuinfo").is_file():
        assert name.endswith(" cpus")


@pytest.mark.parametrize("model_name,want", [
    ("Example CPU 9000", "Example CPU 9000, 2 cpus"),
    ("unknown", "GenuineIntel family 6 model 207, 2 cpus")])
def test_cpu_model_falls_back_to_family_and_model(tmp_path, model_name,
                                                  want):
    block = (f"processor\t: {{}}\nvendor_id\t: GenuineIntel\n"
             f"cpu family\t: 6\nmodel\t\t: 207\n"
             f"model name\t: {model_name}\n")
    path = tmp_path / "cpuinfo"
    path.write_text(block.format(0) + "\n" + block.format(1))
    assert hostbench.cpu_model(str(path)) == want
    assert hostbench.cpu_model(str(tmp_path / "missing")) == ""


@pytest.mark.parametrize("section,prefix", [
    ("primitives", ("fig1_", "fig2_", "fig3_", "table5_", "headline_",
                    "sync_")),
    ("hostbench", ("host_",)), ("kernels", ("kernel_",)),
    ("membench", ("membench_",))])
def test_run_sections_print_their_rows(capsys, monkeypatch, section,
                                       prefix):
    # the --fast sweeps take minutes on the CPU: one small block list each
    monkeypatch.setattr(primitives, "FAST_TESLA_BLOCKS", (1, 2))
    monkeypatch.setattr(primitives, "FAST_FERMI_BLOCKS", (1, 2))
    run.main(["--fast", "--section", section, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = lines[1:]
    assert rows and all(r.startswith(prefix) for r in rows), rows
    assert all(len(r.split(",")) >= 3 for r in rows)
    if section == "kernels":
        assert all(",nan,match=1" in r for r in rows), rows
    if section == "hostbench":
        assert len(rows) == 10 and all(r.split(",")[0].endswith("_t4")
                                       for r in rows)
    if section == "membench":
        assert len(rows) == 24 + 2 + 1
        assert rows[-1].startswith("membench_host_classify,")
    if section == "primitives":
        names = [r.split(",")[0] for r in rows]
        assert "fig2_tesla_mutex_fa_b2" in names
        assert "fig3_fermi_sem120_sleeping_b2" in names
        assert "headline_sleepsem_vs_spin_tesla" in names
        assert "sync_barrier_ref" in names and not any(
            n.endswith("_cuda") for n in names)
        assert [r for r in rows if r.startswith("table5_selection")][0] \
            .split(",")[2].startswith("match=8/8")


@pytest.mark.parametrize("section", ["roofline"])
def test_run_offers_no_section_the_port_lacks(section):
    with pytest.raises(SystemExit):
        run.main(["--section", section])


def test_run_kernels_refuse_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--section", "kernels"])
