"""The port's block programs of the paper's algorithms
(``repro_torch.core.primitives_sim``) against the JAX package's
(``repro.core.primitives_sim``): every ``run_primitive`` result equal
field by field — simulated time, rate, atomics, volatiles, hostage
conversions, FIFO fairness, violations, truncation — with no tolerance.
Then the reference's safety and atomics-accounting claims
(``tests/test_primitives_sim.py``) on the port."""

import dataclasses

import pytest

try:  # hypothesis is optional in this image (tests/_hypothesis_compat.py)
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

from repro.core import abstraction as jabs
from repro.core import primitives_sim as jp
from repro_torch.core import abstraction as tabs
from repro_torch.core import primitives_sim as tp

MACHINES = {"tesla": (jabs.TESLA, tabs.TESLA),
            "fermi": (jabs.FERMI, tabs.FERMI)}
PAIRS = ([("mutex", i) for i in jp.MUTEX_IMPLS]
         + [("semaphore", i) for i in jp.SEMAPHORE_IMPLS]
         + [("barrier", i) for i in jp.BARRIER_IMPLS])


def _both(machine, primitive, impl, **kw):
    jmach, tmach = MACHINES[machine]
    want = dataclasses.asdict(jp.run_primitive(jmach, primitive, impl, **kw))
    got = dataclasses.asdict(tp.run_primitive(tmach, primitive, impl, **kw))
    return got, want


def test_layout_and_backoffs_equal_the_reference():
    for name in ("A_LOCK", "A_TURN", "A_SEM", "A_SEM_TICKET", "A_SEM_TURN",
                 "A_BAR_COUNT", "A_BAR_GEN", "FLAGS_BASE", "MUTEX_IMPLS",
                 "SEMAPHORE_IMPLS", "BARRIER_IMPLS"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("SPIN_BACKOFF", "POLL_BACKOFF"):
        assert dataclasses.asdict(getattr(tp, name)) \
            == dataclasses.asdict(getattr(jp, name)), name
    assert [f.name for f in dataclasses.fields(tp.PrimitiveResult)] \
        == [f.name for f in dataclasses.fields(jp.PrimitiveResult)]


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("primitive,impl", PAIRS,
                         ids=[f"{p}-{i}" for p, i in PAIRS])
def test_run_primitive_equals_the_reference(machine, primitive, impl):
    """Blocks 1, 8 and 24, a small op count, at two semaphore initial
    values (the others ignore ``initial``)."""
    for blocks in (1, 8, 24):
        for initial in ((1, 3) if primitive == "semaphore" else (1,)):
            got, want = _both(machine, primitive, impl, blocks=blocks,
                              ops=4, initial=initial,
                              max_events=2_000_000)
            assert got == want, (blocks, initial)
            assert not got["truncated"]


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("primitive,impl", PAIRS,
                         ids=[f"{p}-{i}" for p, i in PAIRS])
def test_truncated_prefix_equals_the_reference(machine, primitive, impl):
    """A small event budget truncates every run: the rate over the
    completed prefix, and the fairness verdict on it, are the
    reference's."""
    got, want = _both(machine, primitive, impl, blocks=24, ops=6, initial=2,
                      max_events=150)
    assert got == want
    assert got["truncated"]


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_critical_sections_and_backoff_equal_the_reference(machine):
    """A critical section's work, a pinned backoff window, and the
    monitor's entry order (through ``_is_fifo_fair``)."""
    bo = dict(i_min=2, i_max=16)
    for primitive, impl in (("mutex", "spin_backoff"), ("mutex", "fa"),
                            ("mutex", "fa_backoff"),
                            ("semaphore", "spin_backoff"),
                            ("semaphore", "sleeping")):
        jmach, tmach = MACHINES[machine]
        want = jp.run_primitive(jmach, primitive, impl, blocks=12, ops=3,
                                initial=2, cs_us=0.05,
                                backoff=jp.BackoffConfig(**bo))
        got = tp.run_primitive(tmach, primitive, impl, blocks=12, ops=3,
                               initial=2, cs_us=0.05,
                               backoff=tp.BackoffConfig(**bo))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), impl
        assert got.violations == 0


@pytest.mark.parametrize("entries,blocks", [
    ([], 3), ([0, 1, 2, 0, 1, 2], 3), ([0, 0, 0, 1, 2], 3),
    ([0, 0, 0, 0, 0, 0, 1, 2], 3), ([2, 1, 0], 3), ([0, 1], 3),
    ([3, 3, 1, 1, 2, 0, 0], 4)])
def test_fifo_fairness_rule_equals_the_reference(entries, blocks):
    assert tp._is_fifo_fair(entries, blocks) \
        == jp._is_fifo_fair(entries, blocks)


def test_monitor_equals_the_reference():
    mons = [mod.CriticalSectionMonitor(capacity=2) for mod in (jp, tp)]
    for m in mons:
        for bid in (0, 1, 2):
            m.enter(bid)
        m.leave(1)
        m.enter(3)
    assert dataclasses.asdict(mons[1]) == dataclasses.asdict(mons[0])
    assert mons[1].violations == 2 and mons[1].max_inside == 3


# ---------------------------------------------- the reference's safety claims
@settings(max_examples=12, deadline=None)
@given(machine=st.sampled_from(["tesla", "fermi"]),
       impl=st.sampled_from(["spin", "spin_backoff", "fa", "fa_backoff"]),
       blocks=st.integers(2, 24))
def test_mutex_mutual_exclusion(machine, impl, blocks):
    got, want = _both(machine, "mutex", impl, blocks=blocks, ops=6,
                      cs_us=0.05, max_events=4_000_000)
    assert got == want
    assert got["violations"] == 0


@settings(max_examples=12, deadline=None)
@given(machine=st.sampled_from(["tesla", "fermi"]),
       impl=st.sampled_from(["sleeping", "spin_backoff"]),
       blocks=st.integers(2, 24), initial=st.integers(1, 8))
def test_semaphore_capacity_bound(machine, impl, blocks, initial):
    got, want = _both(machine, "semaphore", impl, blocks=blocks, ops=5,
                      initial=initial, cs_us=0.05, max_events=4_000_000)
    assert got == want
    assert got["violations"] == 0


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_fa_mutex_fifo_fair(machine):
    r = tp.run_primitive(MACHINES[machine][1], "mutex", "fa", blocks=16,
                         ops=8)
    assert r.fair_fifo


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("impl", ["atomic", "xf"])
def test_barriers_complete(machine, impl):
    r = tp.run_primitive(MACHINES[machine][1], "barrier", impl, blocks=24,
                         ops=10)
    assert not r.truncated and r.ops_per_sec > 0


# ------------------------------------------------- atomics accounting
def test_fa_mutex_bounds_atomics():
    """One atomic per lock(), zero in unlock()."""
    r = tp.run_primitive(tabs.TESLA, "mutex", "fa", blocks=8, ops=10)
    assert r.atomic_ops == 8 * 10


def test_sleeping_semaphore_bounds_atomics():
    r = tp.run_primitive(tabs.TESLA, "semaphore", "sleeping", blocks=8,
                         ops=10, initial=2)
    assert r.atomic_ops <= 8 * 10 * 4


def test_spin_mutex_unbounded_atomics():
    r = tp.run_primitive(tabs.TESLA, "mutex", "spin", blocks=16, ops=5,
                         max_events=4_000_000)
    assert r.atomic_ops > 16 * 5


def test_xf_barrier_uses_no_atomics():
    r = tp.run_primitive(tabs.TESLA, "barrier", "xf", blocks=32, ops=5)
    assert r.atomic_ops == 0


def test_backoff_config_wraps():
    bo = tp.BackoffConfig(i_min=2, i_max=4)
    i, seen = 2, []
    for _ in range(5):
        seen.append(i)
        i = bo.advance(i)
    assert seen == [2, 3, 4, 2, 3]
    assert bo.next_sleep_us(3, tabs.FERMI) \
        == jp.BackoffConfig(i_min=2, i_max=4).next_sleep_us(3, jabs.FERMI)


@pytest.mark.parametrize("primitive,impl", [("mutex", "ticket"),
                                            ("semaphore", "fa"),
                                            ("barrier", "flag"),
                                            ("rwlock", "spin")])
def test_unknown_names_raise_as_the_reference(primitive, impl):
    for mod, mach in ((jp, jabs.TESLA), (tp, tabs.TESLA)):
        with pytest.raises(ValueError):
            mod.run_primitive(mach, primitive, impl, blocks=2, ops=1)
