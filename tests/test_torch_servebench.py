"""The serving benchmark's twin (``repro_torch.benchmarks.servebench``),
held to the JAX package's ``benchmarks/servebench.py`` (loaded by file
path) on the same seeds and arguments:

* the trace helpers, array for array, on three seeds;
* ``main`` at the reference CI's command line with 6 requests: the four
  reports have the reference's key sets, and every number a clock did
  not measure is equal — the one exception the trace counters
  ``dispatch_traces`` / ``dispatch_retraces``, ``null`` in the port,
  which jit-traces nothing; ``dispatch_trace_keys`` equal;
* every ``bench_slot_engine`` call of that run (slots, paged lazy and
  eager, sharing on and off, chunked and one-shot, gather and fused,
  the open loop's closed-loop driver): its arguments, its non-timing
  row and its greedy streams;
* ``bench_prefix_cache`` (6 requests, 5 fuzz traces) and ``bench_chaos``
  (8 requests) called directly;
* the open loop's accounting and survivor gate;
* ``ci_gates``: every count-and-stream gate passes on the run, and a
  doctored report fails the gate it names.

Reduced qwen3-14b, float32, the reference's weights through the bridge;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Tolerance: exact, for every key that is not a time."""

import contextlib
import copy
import importlib.util
import json
import pathlib
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro
import repro.core.hostsync
import repro.serve.faults
import repro_torch
import repro_torch.core.hostsync
import repro_torch.serve.faults
from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.benchmarks import servebench as sb
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPORTS = ("serve", "cache", "chaos", "frontend")
#: the reference CI's servebench command line, at 6 requests
CI_ARGS = ["--smoke", "--kv-layout", "both", "--prefix-sharing", "both",
           "--requests", "6"]
#: main's bench_slot_engine calls in order (--smoke: K 1 then K 4)
CALLS = ("slots_K1", "paged_lazy_K1", "paged_eager_K1", "slots_K4",
         "paged_lazy_K4", "paged_eager_K4", "sharing_on", "sharing_off",
         "gather", "fused", "interleaved_chunked", "interleaved_one_shot",
         "open_loop_closed")
#: the settings each call must have run with
CALL_SETTINGS = {
    "slots_K1": dict(capacity=1, kv_layout="slots"),
    "paged_lazy_K1": dict(capacity=1, kv_layout="paged", page_growth="lazy"),
    "paged_eager_K1": dict(capacity=1, kv_layout="paged",
                           page_growth="eager"),
    "slots_K4": dict(capacity=4, kv_layout="slots"),
    "paged_lazy_K4": dict(capacity=4, kv_layout="paged", page_growth="lazy"),
    "paged_eager_K4": dict(capacity=4, kv_layout="paged",
                           page_growth="eager"),
    "sharing_on": dict(prefix_sharing="on"),
    "sharing_off": dict(prefix_sharing="off"),
    "gather": dict(attention_impl="gather", prefill_chunk_tokens=16),
    "fused": dict(attention_impl="fused", prefill_chunk_tokens=16),
    "interleaved_chunked": dict(prefill_chunk_tokens=16,
                                bucketed_dispatch="off"),
    "interleaved_one_shot": dict(prefill_chunk_tokens=None,
                                 bucketed_dispatch="off"),
    "open_loop_closed": dict(prefix_sharing="on", prefill_chunk_tokens=8),
}
TRACE_COUNTERS = ("dispatch_traces", "dispatch_retraces")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced model's ops are too small to gain from intra-op
    threads, and several test processes share the CPU: one thread each
    keeps this module's runs from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_servebench", ROOT / "benchmarks" / "servebench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load_reference()


@pytest.fixture(scope="module")
def weights():
    """The reference main's weights (reduced, ``PRNGKey(seed 0)``) and
    the port's copy of them."""
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _run_main(mod, argv, out_dir, **inject):
    """``mod.main`` writing its four reports into ``out_dir``, with every
    ``bench_slot_engine`` call recorded: (kwargs, prompts, arrivals,
    row, streams). Returns (reports, calls)."""
    calls = []
    orig = mod.bench_slot_engine

    def recording(model, params, prompts, arrivals, **kw):
        row, streams = orig(model, params, prompts, arrivals, **kw)
        calls.append((kw, prompts, arrivals, row, streams))
        return row, streams

    paths = {name: out_dir / f"{name}.json" for name in REPORTS}
    mod.bench_slot_engine = recording
    try:
        mod.main(argv + ["--out", str(paths["serve"]),
                         "--cache-out", str(paths["cache"]),
                         "--chaos-out", str(paths["chaos"]),
                         "--frontend-out", str(paths["frontend"])], **inject)
    finally:
        mod.bench_slot_engine = orig
    return {k: json.loads(p.read_text()) for k, p in paths.items()}, calls


class HolderClock:
    """The clock the allocator watchdog reads during :func:`runs`: the
    holding thread's own CPU time, plus the stalls a fault plan injects
    on that thread. The watchdog counts critical sections held past 3
    ms; on the wall clock a loaded host decides that count, since a
    holder the scheduler preempts stays "held" while other processes
    run (the chaos baseline then trips, and the gate ``watchdog_trips
    == 0`` fails). A preempted thread accrues no CPU time, so on this
    clock only a stuck holder, stalled 10 ms by the fault plan, outlasts
    the watchdog, however busy the host is."""

    def __init__(self):
        self._stalled = threading.local()

    def perf_counter(self) -> float:
        return time.thread_time() + getattr(self._stalled, "s", 0.0)

    def sleep(self, seconds: float) -> None:
        self._stalled.s = getattr(self._stalled, "s", 0.0) + seconds
        time.sleep(seconds)


@contextlib.contextmanager
def holder_clock():
    """Both packages' mutex watchdogs on a :class:`HolderClock`, their
    fault plans' stalls counted on it; every other use of ``time`` in
    those modules untouched."""
    clock = HolderClock()

    def time_with(**override):
        names = {k: getattr(time, k) for k in dir(time)
                 if not k.startswith("_")}
        return types.SimpleNamespace(**dict(names, **override))

    with pytest.MonkeyPatch.context() as mp:
        for mod in (repro.core.hostsync, repro_torch.core.hostsync):
            mp.setattr(mod, "time",
                       time_with(perf_counter=clock.perf_counter))
        for mod in (repro.serve.faults, repro_torch.serve.faults):
            mp.setattr(mod, "time", time_with(sleep=clock.sleep))
        yield clock


@pytest.fixture(scope="module")
def runs(ref, weights, tmp_path_factory):
    """The reference main and the twin's on the same arguments and
    weights (the twin on the CPU): {"jax": ..., "port": ...} of
    (reports, calls). The watchdogs run on :class:`HolderClock`."""
    _, _, tm, tp = weights
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    with holder_clock():
        return {"jax": _run_main(ref, CI_ARGS, jdir),
                "port": _run_main(sb, CI_ARGS + ["--device", "cpu"], tdir,
                                  model=tm, params=tp)}


def _strip_counters(obj):
    """``obj`` without the jit-trace counters (the port's are null)."""
    if isinstance(obj, dict):
        return {k: _strip_counters(v) for k, v in obj.items()
                if k not in TRACE_COUNTERS}
    return obj


def _counters(obj):
    """Every trace-counter value anywhere in ``obj``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in TRACE_COUNTERS:
                yield v
            else:
                yield from _counters(v)


def _key_paths(obj, prefix=""):
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            out.add(prefix + k)
            out |= _key_paths(v, prefix + k + "/")
        return out
    return set()


# ------------------------------------------------------------ trace helpers
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_trace_helpers_equal_the_reference(ref, seed):
    for load, k, new in ((0.8, 1, 8), (1.0, 4, 8), (1.2, 4, 16)):
        want = ref.poisson_arrival_steps(24, k, new, load,
                                         np.random.default_rng(seed))
        got = sb.poisson_arrival_steps(24, k, new, load,
                                       np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    want = ref.shared_prefix_prompts(10, 17, 3, 512,
                                     np.random.default_rng(seed))
    got = sb.shared_prefix_prompts(10, 17, 3, 512,
                                   np.random.default_rng(seed))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for n, groups, chunk in ((16, 2, 4), (7, 3, 2)):
        assert np.array_equal(sb.staggered_arrivals(n, groups, chunk),
                              ref.staggered_arrivals(n, groups, chunk))
    # the closed-loop trace: prompts, then arrivals per capacity, from
    # one generator, as the reference main draws them
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, 512, (6, 16)).astype(np.int32)
    arrivals = [ref.poisson_arrival_steps(6, k, 8, 1.0, rng) for k in (1, 4)]
    got_p, got_a = sb.closed_loop_trace(seed, 6, 16, 512, [1, 4], 8, 1.0)
    assert np.array_equal(got_p, prompts)
    assert all(np.array_equal(got_a[k], a) for k, a in zip((1, 4), arrivals))


# --------------------------------------------------------------------- main
@pytest.mark.parametrize("report", REPORTS)
def test_main_reports_equal_the_reference(runs, report):
    """Same key sets; every number a clock did not measure equal; the
    trace counters null in the port."""
    want = runs["jax"][0][report]
    got = runs["port"][0][report]
    assert _key_paths(got) == _key_paths(want)
    assert all(v is None for v in _counters(got))
    assert sb.untimed(_strip_counters(got), open_loop=report == "frontend") \
        == sb.untimed(_strip_counters(want), open_loop=report == "frontend")


def test_main_dispatch_trace_keys_equal_the_reference(runs):
    """The distinct dispatch shapes equal the reference's distinct trace
    keys on every row, and the bucketed rows dispatched some."""
    want, got = runs["jax"][0]["serve"], runs["port"][0]["serve"]
    pairs = [(w["dispatch_trace_keys"], g["dispatch_trace_keys"])
             for w, g in ((want[s][m], got[s][m])
                          for s in ("slots", "paged", "paged_eager",
                                    "paged_prefix", "paged_fused",
                                    "interleaved")
                          for m in want[s] if isinstance(want[s][m], dict))]
    assert len(pairs) == 12
    assert all(w == g for w, g in pairs)
    assert got["paged_fused"]["fused"]["dispatch_trace_keys"] > 0


@pytest.mark.parametrize("label", CALLS)
def test_bench_slot_engine_equals_the_reference(runs, label):
    """One bench_slot_engine call of main: its settings and trace, its
    row but for the times and trace counters, and its greedy streams."""
    i = CALLS.index(label)
    jcalls, tcalls = runs["jax"][1], runs["port"][1]
    assert len(jcalls) == len(tcalls) == len(CALLS)
    jkw, jprompts, jarr, jrow, jstreams = jcalls[i]
    tkw, tprompts, tarr, trow, tstreams = tcalls[i]
    assert tkw.pop("device") == torch.device("cpu")
    assert tkw == jkw
    defaults = sb.bench_slot_engine.__kwdefaults__
    for key, val in CALL_SETTINGS[label].items():
        assert (tkw[key] if key in tkw else defaults[key]) == val, key
    assert all(np.array_equal(a, b) for a, b in zip(tprompts, jprompts))
    assert np.array_equal(tarr, jarr)
    assert trow["dispatch_traces"] is None and trow["dispatch_retraces"] \
        is None
    assert sb.untimed(_strip_counters(trow)) \
        == sb.untimed(_strip_counters(jrow))
    assert tstreams == {r: list(map(int, s)) for r, s in jstreams.items()}
    assert trow["fifo_ok"] and len(tstreams) == len(tprompts)


def test_open_loop_accounting_and_survivors(runs):
    """Every client accounted for, no page leaked, survivors equal to
    the closed-loop driver, FIFO grants, at least one cancel."""
    fe = runs["port"][0]["frontend"]
    assert fe["finished"] + fe["cancelled"] + fe["expired"] + fe["shed"] \
        == fe["requests"] == 6
    assert fe["survivor_streams_match_closed_loop"] is True
    assert fe["leaked_pages"] == 0 and fe["fifo_ok"]
    assert fe["cancelled"] > 0
    assert fe["ttft_p50_ms"] > 0 and fe["goodput_tok_per_s"] > 0


# ------------------------------------------------------------ direct calls
def test_bench_prefix_cache_equals_the_reference(ref, weights):
    jm, jp, tm, tp = weights
    kw = dict(capacity=4, decode_chunk=4, seed=0, page_size=8, vocab=512,
              requests=6, fuzz_traces=5)
    want = ref.bench_prefix_cache(jm, jp, **kw)
    got = sb.bench_prefix_cache(tm, tp, device="cpu", **kw)
    assert sb.untimed(got) == sb.untimed(want)
    assert got["on"]["fuzz_traces_passed"] \
        == want["on"]["fuzz_traces_passed"]
    assert got["on"]["tokens_match_off"] is True
    assert got["on"]["leaked_pages"] == got["off"]["leaked_pages"] == 0


def test_bench_chaos_equals_the_reference(ref, weights):
    jm, jp, tm, tp = weights
    kw = dict(capacity=4, decode_chunk=4, seed=0, page_size=8, vocab=512,
              requests=8, fault_seed=0, alloc_rate=0.2, dispatch_rate=0.2,
              stuck_rate=0.2, max_faults=6)
    want = ref.bench_chaos(jm, jp, **kw)
    got = sb.bench_chaos(tm, tp, device="cpu", **kw)
    assert sb.untimed(got) == sb.untimed(want)
    assert got["chaos"]["faults_injected"] > 0
    assert got["poison"]["requests_quarantined"] == 1
    # every stuck holder (held 10 ms) trips the 3 ms watchdog; on a
    # loaded host an ordinary critical section may trip it too
    stuck = got["chaos"]["faults_by_kind"].get("stuck", 0)
    assert stuck > 0 and got["chaos"]["watchdog_trips"] >= stuck


# -------------------------------------------------------------------- gates
@pytest.mark.parametrize("pkg", [repro_torch, repro], ids=["port", "jax"])
def test_holder_clock_counts_stalls_not_preemption(pkg):
    """On :class:`HolderClock` a critical section the host keeps off the
    CPU for 20 ms (a real sleep: the thread runs nothing) trips no
    watchdog of 3 ms, while a fault plan's 10 ms stall inside one does,
    in either package's mutex."""
    with holder_clock():
        mutex = pkg.core.hostsync.TicketMutex()
        mutex.set_watchdog(3e-3)
        plan = pkg.serve.faults.FaultPlan(seed=0, stuck_rate=1.0,
                                          stuck_hold_s=10e-3, max_faults=1)
        with mutex:
            time.sleep(20e-3)
        assert mutex.watchdog_trips == 0
        with mutex:
            plan.alloc_hook("grant")
        assert plan.by_kind == {"stuck": 1}
        assert mutex.watchdog_trips == 1


def test_ci_gates_hold_on_the_run(runs):
    """Every gate of counts and streams passes on the twin's run. The
    wall-clock gate's verdict is a time, not part of the exact parity."""
    r = runs["port"][0]
    failed = sb.ci_gates(r["serve"], r["cache"], r["frontend"], r["chaos"])
    assert [f for f in failed if not f.startswith(sb.WALL_CLOCK_STEP)] == []
    # the reference's own run passes the same gates
    j = runs["jax"][0]
    failed = sb.ci_gates(j["serve"], j["cache"], j["frontend"], j["chaos"])
    assert [f for f in failed if not f.startswith(sb.WALL_CLOCK_STEP)] == []


DOCTORED = [
    ("serve", ("paged", "4", "eager_lazy_tokens_match"), False,
     "lock traffic K=4"),
    ("serve", ("paged", "1", "lock_drop_vs_pr3_per_page"), 3.0,
     "lock traffic: drop"),
    ("serve", ("paged_prefix", "on", "cow_splits"), 0, "prefix sharing"),
    ("serve", ("interleaved", "chunked", "decode_rounds_stalled_by_prefill"),
     2, "interleaved:"),
    ("serve", ("interleaved", "chunked", "p99_wait_s_drop_vs_unchunked"),
     0.5, "interleaved wall clock"),
    ("cache", ("on", "fuzz_traces_passed"), 199, "prefix cache"),
    ("frontend", ("leaked_pages",), 2, "open loop"),
    ("chaos", ("poison", "failed_rids"), [], "chaos"),
    ("chaos", ("chaos", "lock_ratio_vs_baseline"), 1.06, "chaos"),
    ("serve", ("paged_fused", "fused", "dispatch_trace_keys"), 7,
     "fused decode"),
    ("serve", ("paged_fused", "gather", "dispatch_trace_keys"), 0,
     "fused decode"),
    ("serve", ("paged_fused",), None, "fused decode: report lacks"),
]


@pytest.mark.parametrize("report,path,value,names", DOCTORED,
                         ids=[f"{d[0]}-{'/'.join(d[1])}" for d in DOCTORED])
def test_ci_gates_name_the_doctored_gate(runs, report, path, value, names):
    r = copy.deepcopy(runs["port"][0])
    r["serve"]["interleaved"]["chunked"]["p99_wait_s_drop_vs_unchunked"] = 2.0
    node = r[report]
    for key in path[:-1]:
        node = node[key]
    if value is None:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    failed = sb.ci_gates(r["serve"], r["cache"], r["frontend"], r["chaos"])
    assert failed and all(f.startswith(names) for f in failed), failed


# --------------------------------------------------------------------- card
def test_cuda_servebench_reduced_gates_and_parity():
    """The reduced run on the card: every count-and-stream gate passes,
    and every number a clock did not measure equals the CPU run's from
    the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.models.common import tree_map
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm = build_model(get_arch("qwen3-14b").reduced())
    cpu = tm.init(torch.Generator().manual_seed(0), "cpu")
    reports = {}
    try:
        for dev, params in (("cuda", tree_map(lambda t: t.to("cuda"), cpu)),
                            ("cpu", cpu)):
            reports[dev] = sb.main(
                CI_ARGS + ["--device", dev, "--out", "", "--cache-out", "",
                           "--chaos-out", "", "--frontend-out", ""],
                model=tm, params=params)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    r = reports["cuda"]
    failed = sb.ci_gates(r, r["prefix_cache"], r["frontend"], r["chaos"])
    assert [f for f in failed if not f.startswith(sb.WALL_CLOCK_STEP)] == []
    assert sb.untimed(reports["cuda"]) == sb.untimed(reports["cpu"])
    # on the card's idle host only the stuck holders trip the watchdog
    for rep in reports.values():
        ch = rep["chaos"]["chaos"]
        assert ch["watchdog_trips"] == ch["faults_by_kind"]["stuck"] > 0
