"""The port's memory-system simulator (``repro_torch.core.memsim``) against
the JAX package's (``repro.core.memsim``): both are plain Python, so every
simulated time, counter and memory word must be equal, not close — no
tolerance is used. Then the reference's own claims
(``tests/test_memsim.py``) on the port."""

import dataclasses
import itertools

import pytest

from repro.core import abstraction as jabs
from repro.core import memsim as jm
from repro_torch.core import abstraction as tabs
from repro_torch.core import memsim as tm

MACHINES = {"tesla": (jabs.TESLA, tabs.TESLA),
            "fermi": (jabs.FERMI, tabs.FERMI)}

# every Table-1 cell: (kind, contentious, write); kind vol / atm / vpa
CELLS = list(itertools.product(("vol", "atm", "vpa"), (True, False),
                               (False, True)))


def _cell_kw(kind, contentious, write):
    return dict(atomic=kind == "atm", contentious=contentious, write=write,
                preceded_by_atomic=kind == "vpa")


def test_constants_equal_the_reference():
    assert tm.LINE_WORDS == jm.LINE_WORDS == 32
    assert [tm.line_of(a) for a in range(200)] \
        == [jm.line_of(a) for a in range(200)]
    assert dataclasses.asdict(tm.SimStats()) \
        == dataclasses.asdict(jm.SimStats())
    jsim, tsim = jm.MemSim(jabs.TESLA), tm.MemSim(tabs.TESLA)
    assert (tsim.warp_width, tsim.jitter, tsim._rng_state) \
        == (jsim.warp_width, jsim.jitter, jsim._rng_state)
    # the xorshift sequence, salted as the engine salts it (by block id)
    assert [tsim._rand01(s) for s in range(64)] \
        == [jsim._rand01(s) for s in range(64)]


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("kind,contentious,write", CELLS,
                         ids=[f"{k}-{'cont' if c else 'nonc'}-"
                              f"{'w' if w else 'r'}" for k, c, w in CELLS])
def test_table1_cell_equals_the_reference(machine, kind, contentious,
                                          write):
    """One Table-1 cell at 200 accesses: ``run_membench``'s ms, and the
    same run through ``MemSim`` — simulated time, every ``SimStats``
    field and the memory words — equal the reference's exactly."""
    jmach, tmach = MACHINES[machine]
    kw = _cell_kw(kind, contentious, write)
    want = jm.run_membench(jmach, accesses=200, **kw)
    got = tm.run_membench(tmach, accesses=200, **kw)
    assert got == want
    jsim, tsim = jm.MemSim(jmach), tm.MemSim(tmach)
    jus = jsim.run([jm.membench_program(accesses=50, **kw)] * 12)
    tus = tsim.run([tm.membench_program(accesses=50, **kw)] * 12)
    assert tus == jus
    assert dataclasses.asdict(tsim.stats) == dataclasses.asdict(jsim.stats)
    assert tsim.mem == jsim.mem and tsim.now == jsim.now


def _mixed_program(n_blocks):
    """Every op kind: atomics and volatiles on one line (the Fermi
    hostage rule), warp scans and broadcasts over flag arrays, sleeps."""
    flags = 4 * jm.LINE_WORDS

    def prog(sim, bid):
        old = yield ("atomic_add", 0, 1)
        yield ("load", 1)                      # same line as word 0
        yield ("store", 2, bid + old)
        yield ("atomic_exch", 3, bid)
        yield ("store", flags + bid, 1)
        yield ("sleep", 0.25 * (bid + 1))
        ok = yield ("scan_flags", flags, n_blocks, 1)
        if bid == 0:
            yield ("broadcast_store", flags + 2 * jm.LINE_WORDS, 300, ok)
        v = yield ("load", 5 * jm.LINE_WORDS + bid)
        yield ("store", 5 * jm.LINE_WORDS + bid, v + 7)
        yield ("atomic_add", jm.LINE_WORDS, bid)
        yield ("load", jm.LINE_WORDS + 1)

    return prog


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("warp_width,jitter", [(128, 0.02), (32, 0.02),
                                               (128, 0.0)])
def test_memsim_op_by_op_equals_the_reference(machine, warp_width, jitter):
    jmach, tmach = MACHINES[machine]
    jsim = jm.MemSim(jmach, warp_width=warp_width, jitter=jitter)
    tsim = tm.MemSim(tmach, warp_width=warp_width, jitter=jitter)
    n = 40
    jus = jsim.run([_mixed_program(n)] * n)
    tus = tsim.run([_mixed_program(n)] * n)
    assert tus == jus
    assert tsim.mem == jsim.mem
    assert dataclasses.asdict(tsim.stats) == dataclasses.asdict(jsim.stats)
    assert tsim.stats.sleeps == n
    if machine == "fermi":
        assert tsim.stats.hostage_conversions > 0
    else:
        assert tsim.stats.hostage_conversions == 0
    lines = {k: dataclasses.asdict(v) for k, v in tsim.lines.items()}
    assert lines == {k: dataclasses.asdict(v) for k, v in jsim.lines.items()}


def test_event_budget_error_equals_the_reference():
    def stuck(sim, bid):
        while True:
            v = yield ("load", 0)
            if v == 42:
                break

    errors = []
    for mod, mach in ((jm, jabs.TESLA), (tm, tabs.TESLA)):
        sim = mod.MemSim(mach)
        with pytest.raises(RuntimeError) as e:
            sim.run([stuck] * 3, max_events=1000)
        errors.append((str(e.value), sim.now,
                       dataclasses.asdict(sim.stats)))
    assert errors[0] == errors[1]
    assert "event budget exceeded" in errors[1][0]


def test_unknown_op_and_atomic_free_machine_raise_as_the_reference():
    def bad(sim, bid):
        yield ("fence", 0)

    for mod, mach in ((jm, jabs.TESLA), (tm, tabs.TESLA)):
        with pytest.raises(ValueError, match="unknown op 'fence'"):
            mod.MemSim(mach).run([bad])

    def atomic(sim, bid):
        yield ("atomic_add", 0, 1)

    for mod, mach in ((jm, jabs.TPU_V5E), (tm, tabs.TPU_V5E)):
        with pytest.raises(RuntimeError, match="has no atomics"):
            mod.MemSim(mach).run([atomic])


# ------------------------------------------ the reference's claims, on the port
TABLE1_READS = {
    ("tesla", False, True): 0.848, ("tesla", False, False): 0.590,
    ("tesla", True, True): 78.407, ("fermi", False, True): 0.494,
    ("fermi", False, False): 0.043, ("fermi", True, True): 1.479,
}


@pytest.mark.parametrize("machine_name,atomic,contentious",
                         sorted(TABLE1_READS))
def test_table1_reads_within_10pct(machine_name, atomic, contentious):
    paper = TABLE1_READS[(machine_name, atomic, contentious)]
    sim = tm.run_membench(MACHINES[machine_name][1], atomic=atomic,
                          contentious=contentious, write=False,
                          accesses=150)
    assert paper / 1.10 < sim < paper * 1.10, (sim, paper)


def test_fermi_line_hostage_cascade():
    """Volatile-after-atomic under contention collapses to atomic speed
    on Fermi (paper Section 3) but not on Tesla."""
    fermi_vpa = tm.run_membench(tabs.FERMI, atomic=False, contentious=True,
                                write=False, preceded_by_atomic=True,
                                accesses=150)
    fermi_atomic = tm.run_membench(tabs.FERMI, atomic=True,
                                   contentious=True, write=False,
                                   accesses=150)
    assert fermi_vpa > 0.8 * fermi_atomic
    tesla_vpa = tm.run_membench(tabs.TESLA, atomic=False, contentious=True,
                                write=False, preceded_by_atomic=True,
                                accesses=150)
    tesla_vol = tm.run_membench(tabs.TESLA, atomic=False, contentious=True,
                                write=False, accesses=150)
    assert tesla_vpa < 2.0 * tesla_vol


def test_atomicity_of_rmw():
    sim = tm.MemSim(tabs.TESLA)

    def prog(s, bid):
        for _ in range(50):
            yield ("atomic_add", 0, 1)

    sim.run([prog] * 16)
    assert sim.peek(0) == 16 * 50


def test_line_mapping():
    assert tm.line_of(0) == tm.line_of(tm.LINE_WORDS - 1)
    assert tm.line_of(tm.LINE_WORDS) == 1


def test_scan_and_broadcast_ops():
    sim = tm.MemSim(tabs.FERMI)
    seen = []

    def prog(s, bid):
        yield ("broadcast_store", 0, 10, 7)
        ok = yield ("scan_flags", 0, 10, 7)
        seen.append(ok)

    sim.run([prog])
    assert seen == [True]
    assert all(sim.peek(i) == 7 for i in range(10))
