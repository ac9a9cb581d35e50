"""The paper-table benchmarks of the port (``repro_torch.benchmarks.
membench`` and the simulator part of ``primitives``), the host probe and
``SyncLibrary.for_host``, against the JAX package's
``benchmarks/membench.py`` and ``benchmarks/primitives.py`` (loaded by
file path) on the CPU.

Every simulated row's name and ``derived`` field equals the reference's
letter for letter (only the ``us_per_call`` timing column is stripped);
no tolerance is used. The measured rows (the host probe, the alloc
sweep) keep the reference's names and keys."""

import importlib.util
import json
import math
import pathlib

import pytest

from repro.core import abstraction as jabs
from repro_torch.benchmarks import membench, primitives
from repro_torch.core import abstraction as tabs
from repro_torch.core import hostbench_probe
from repro_torch.sync import SyncLibrary, classified_host
from repro_torch.sync import library as sync_library

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_membench():
    return _reference("membench")


@pytest.fixture(scope="module")
def ref_primitives():
    return _reference("primitives")


def _untimed(rows):
    """``name,us,derived`` -> ``(name, derived)``; comment rows kept."""
    out = []
    for r in rows:
        if r.startswith("#"):
            out.append(r)
            continue
        name, us, derived = r.split(",", 2)
        assert math.isfinite(float(us)) and float(us) >= 0, r
        out.append((name, derived))
    return out


def test_paper_table1_equals_the_reference(ref_membench):
    assert membench.PAPER_TABLE1 == ref_membench.PAPER_TABLE1


def test_sim_table1_rows_equal_the_reference(ref_membench):
    want = _untimed(ref_membench.run_sim_table1(accesses=100))
    got = _untimed(membench.run_sim_table1(accesses=100))
    assert got == want and len(got) == 24
    assert got[0][0] == "membench_sim_tesla_vol_cont_r"


def test_table2_table3_rows_equal_the_reference(ref_membench):
    got = _untimed(membench.run_table2_table3())
    assert got == _untimed(ref_membench.run_table2_table3())
    assert got == [
        ("membench_ratios_tesla",
         "T2_vol=1.43;T2_atm=78.28;T3_cont=92.14;T3_nonc=1.68"),
        ("membench_ratios_fermi",
         "T2_vol=11.37;T2_atm=4.66;T3_cont=2.98;T3_nonc=7.26")]


def test_host_row_keeps_the_reference_fields():
    (row,) = membench.run_host_row(threads=2, accesses=300)
    name, us, derived = row.split(",")
    assert name == "membench_host_classify" and float(us) > 0
    assert [kv.split("=")[0] for kv in derived.split(";")] \
        == ["P1", "P2", "P3"]
    assert all(math.isfinite(float(kv.split("=")[1]))
               for kv in derived.split(";"))


def test_table5_rows_equal_the_reference(ref_primitives):
    got = _untimed(primitives.table5_check())
    assert got == _untimed(ref_primitives.table5_check())
    assert got[0][1].startswith("match=8/8;")


@pytest.mark.parametrize("machine", ["tesla", "fermi"])
def test_sweep_rows_equal_the_reference(ref_primitives, machine):
    jm = jabs.TESLA if machine == "tesla" else jabs.FERMI
    tm = tabs.TESLA if machine == "tesla" else tabs.FERMI
    want = _untimed(ref_primitives.sweep(jm, machine, (1, 4, 8)))
    got = _untimed(primitives.sweep(tm, machine, (1, 4, 8)))
    assert got == want and len(got) == 51
    for name, derived in got:
        assert "viol=" not in derived or "viol=0" in derived, name
        if "_mutex_fa_" in name:
            assert "fair=1" in derived, name


def test_sweep_keeps_the_tesla_spin_cap(ref_primitives, monkeypatch):
    """Past ``SPIN_CAP_TESLA`` blocks the Tesla spin rows are left out,
    as in the reference (only the row names are compared: nothing past
    the cap is simulated)."""
    assert primitives.SPIN_CAP_TESLA == ref_primitives.SPIN_CAP_TESLA
    assert (primitives.TESLA_BLOCKS, primitives.FERMI_BLOCKS) \
        == (ref_primitives.TESLA_BLOCKS, ref_primitives.FERMI_BLOCKS)
    assert (primitives.FAST_TESLA_BLOCKS, primitives.FAST_FERMI_BLOCKS) \
        == ((1, 30, 120, 240), (1, 32, 128))
    cap = primitives.SPIN_CAP_TESLA
    saved = primitives.run_primitive
    calls = []

    def stub(machine, primitive, impl, *, blocks, **kw):
        calls.append((primitive, impl, blocks))
        return saved(machine, primitive, impl, blocks=1, ops=1,
                     initial=kw.get("initial", 1))

    monkeypatch.setattr(primitives, "run_primitive", stub)
    rows = primitives.sweep(tabs.TESLA, "tesla", (1, cap + 1))
    names = [r.split(",")[0] for r in rows]
    assert f"fig2_tesla_mutex_spin_b{cap + 1}" not in names
    assert f"fig3_tesla_sem1_spin_backoff_b{cap + 1}" not in names
    assert f"fig2_tesla_mutex_fa_b{cap + 1}" in names
    assert ("mutex", "spin", cap + 1) not in calls


def test_headline_speedups_equal_the_reference(ref_primitives):
    """The four Section-7 headlines, simulated: the port's strings are
    the reference's (12.1x, 223 %, 116.8x, 234.7x)."""
    got = _untimed(primitives.headline_speedups())
    assert got == _untimed(ref_primitives.headline_speedups())
    assert [d for _, d in got] == ["x=12.1;paper=40", "pct=223;paper=40",
                                   "x=116.8;paper=70", "x=234.7;paper=3"]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if isinstance(tree, bool) else None


def test_alloc_sweep_keeps_the_reference_keys(ref_primitives, tmp_path):
    """Threads 1, 2 and 4 at 50 ops a thread on the real ``PagePool``
    (every arm's ``pool.check()`` passes inside; spin at 4 threads is the
    reference's TRUNC row): the rows' names and the JSON's keys are the
    reference's."""
    kw = dict(threads_list=(1, 2, 4), ops_per_thread=50)
    want_rows = ref_primitives.alloc_sweep(str(tmp_path / "ref.json"), **kw)
    got_rows = primitives.alloc_sweep(str(tmp_path / "port.json"), **kw)
    names = [r.split(",")[0] for r in got_rows[:-1]]
    assert names == [r.split(",")[0] for r in want_rows[:-1]]
    assert "alloc_spin_t4" in names and "alloc_adaptive_t2" in names
    assert got_rows[names.index("alloc_spin_t4")] == "alloc_spin_t4,0.0,TRUNC"
    assert got_rows[-1] == f"# wrote {tmp_path / 'port.json'}"
    for row in got_rows[:-1]:
        if not row.endswith("TRUNC"):
            assert [kv.split("=")[0] for kv in row.split(",")[2].split(";")] \
                == ["acq_per_s", "contended", "final"], row
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert _keys(got) == _keys(want)
    assert (got["num_pages"], got["page_size"], got["ops_per_thread"]) \
        == (192, 8, 50)
    arm = got["arms"]["sleeping"]["2"]
    assert arm["lock_acquires"] > 0 and arm["acquires_per_s"] > 0
    assert got["arms"]["spin"]["4"] == {"truncated": True}


def test_classify_host_is_a_host_abstraction():
    m = hostbench_probe.classify_host(threads=2, accesses=500)
    assert m.name == "host-cpu" and m.saturated_blocks == 2
    times = [getattr(g, f.name) for g in (m.reads, m.writes)
             for f in g.__dataclass_fields__.values()]
    assert len(times) == 12
    assert all(math.isfinite(t) and t > 0 for t in times), times
    assert tabs.select_backend(m) == "host"


def test_for_host_probe_cached_with_refresh_escape(monkeypatch):
    calls = {"n": 0}

    def fake_probe(**kw):
        calls["n"] += 1
        return sync_library.HOST_NOMINAL

    monkeypatch.setattr(hostbench_probe, "classify_host", fake_probe)
    monkeypatch.setattr(sync_library, "_HOST_MACHINES", {})

    SyncLibrary.for_host()
    SyncLibrary.for_host()
    SyncLibrary.for_host()
    assert calls["n"] == 1          # probe ran once, result cached
    SyncLibrary.for_host(refresh=True)
    assert calls["n"] == 2          # explicit escape hatch re-probes
    SyncLibrary.for_host(threads=2)
    SyncLibrary.for_host(threads=2)
    assert calls["n"] == 3          # distinct probe params, distinct entry
    assert classified_host(threads=2) is sync_library.HOST_NOMINAL
    assert calls["n"] == 3


def test_for_host_library_plans_on_the_device_planner(monkeypatch):
    """A library built by ``for_host`` is named ``host-cpu``: live
    objects on ``host``, hot-loop plans on the device's planner."""
    monkeypatch.setattr(sync_library, "_HOST_MACHINES", {})
    lib = SyncLibrary.for_host(threads=2, accesses=200)
    assert lib.machine.name == "host-cpu"
    assert lib.backend_name() == "host"
    assert lib.planning_backend_name("cpu") == "ref"
    assert SyncLibrary.for_host(threads=2, accesses=200).machine \
        is lib.machine
