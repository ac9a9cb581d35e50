"""One run of one cell of the serving benchmark of ``repro_torch``.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. In order: load the port's kernels (built once into
``build/repro_torch/`` of the checkout), make the weights on the card
from the seed, build the engine with the mix's settings, warm every
dispatch shape the cell uses (and, for a mix with documents, prefill
them into the prefix cache), ramp the traffic, measure for ``--seconds``
and check what was served against the float32 reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import weakref  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

from bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the output check's numbers a cell file may give a limit for
GAP_NUMBERS = ("max_gap", "mean_gap")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _program_path(root: Path) -> None:
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def read_metric(root: Path, name: str, ctx) -> Optional[float]:
    """Call ``bench/metrics/<name>.py``'s ``read(ctx)``; a name
    ``<quantity>.<part>`` without a file of its own (one quantity split
    between cells that report different end-to-end metrics) is read by
    ``bench/metrics/<quantity>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(name.split(".")[0] + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    val = mod.read(ctx)
    return None if val is None else float(val)


class Context:
    """What a metric reader gets: the driven run, the trace summary
    (None untraced), the model's sizes, the set-up seconds and when the
    harness stopped waiting."""

    def __init__(self, run, trace, dm, setup_s, t_stopped):
        self.run, self.trace, self.dm = run, trace, dm
        self.setup_s, self.t_stopped = setup_s, t_stopped


def make_engine(model, params, mix: Dict[str, Any], device):
    from repro_torch.serve.engine import SlotServeEngine

    e = dict(mix["engine"])
    ps = int(e["page_size"])
    per_slot = -(-int(e["max_len"]) // ps)
    if e.get("num_pages") is None:
        e["num_pages"] = int(e["capacity"]) * per_slot
    return SlotServeEngine(model, params, max_pages_per_slot=per_slot,
                           device=device, **e)


def load(cell: spec.Cell, seed: int, dev, setup: Dict[str, float]):
    """The program for one run: its kernels (built once into the
    checkout), the weights drawn from ``seed`` on ``dev`` and checked
    against the program's parameter tree, and the engine with the mix's
    settings. Returns ``(dims, weights, engine)``; the seconds of each
    step go into ``setup``."""
    import torch

    from bench import weights
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model_zoo import build_model

    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels.build import CSRC, build
        build(sorted(p.name for p in CSRC.glob("*.cu")))
        torch.cuda.reset_peak_memory_stats(dev)
    setup["import_and_kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dm = spec.dims(cell.config)
    model = build_model(spec.arch_config(cell.config))
    params = weights.make(dm, seed, dev)
    weights.check_against(params, tree_leaves(model.spec_tree()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = make_engine(model, params, cell.mix, dev)
    setup["engine_s"] = time.perf_counter() - t
    return dm, params, engine


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Optional[Path] = None, control: Optional[str] = None,
             log=print) -> Dict[str, Any]:
    """Run ``cell`` once and return the result object. With
    ``control`` the control stands in the program's place in the output
    check (``bench/check.py``): ``correct`` and ``checks`` judge the
    control's readings, and ``program`` holds the program's."""
    import torch

    root = Path(root or spec.ROOT)
    t_start = T_START if t_start is None else t_start
    _program_path(root)
    from bench import check, drive, trace as tracing, traffic

    setup: Dict[str, float] = {}
    dev = torch.device(device)
    dm, params, engine = load(cell, seed, dev, setup)
    mix = cell.mix
    chunk = engine.prefill_chunk

    t = time.perf_counter()
    if mix["loop"] == "open":
        rate = float(cell.cell["rate_per_s"])
        gen = traffic.OpenTraffic(mix, dm["vocab"], seed, rate,
                                  float(mix["warm_s"]) + seconds + 90.0)
        drive.serve_documents(engine, gen.documents)
        setup["documents_s"] = time.perf_counter() - t
        t = time.perf_counter()
        sizes = drive.bucket_sizes(engine.capacity)
    else:
        gen = traffic.ClosedTraffic(mix, dm["vocab"], seed)
        sizes = [engine.capacity]
    drive.warm_shapes(engine, sizes, chunk + 1, dm["vocab"], seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["warm_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()

    tr = mix["trace"]
    trace_at = (float(tr["after_s"]), int(tr["rounds"])) if trace else None
    t = time.perf_counter()
    if mix["loop"] == "open":
        run = drive.run_open(engine, gen, float(mix["warm_s"]), seconds,
                             int(mix["intake_limit"]), trace=trace_at)
    else:
        run = drive.run_closed(engine, gen, dm, seconds, trace=trace_at)
    t_stopped = time.perf_counter()
    setup["ramp_s"] = run.t_open - t
    setup_s = run.t_open - t_start
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    summary = None
    if trace and run.rounds.profiler is not None:
        summary = tracing.read_profiler(run.rounds.profiler,
                                        spec.scratch_dir())
        run.rounds.profiler = None
    ctx = Context(run, summary, dm, setup_s, t_stopped)
    names = cell.per_layer_names() if trace else cell.e2e_names()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name in names:
        val = read_metric(root, name, ctx)
        if val is not None:
            metrics[name] = {"value": val, "unit": units[name]}

    if mix["loop"] == "open":
        due = [r for r in run.recs
               if run.t_open <= r.due < run.t_open + seconds]
        attempted = len(due)
        failed = sum(1 for r in due if not r.times)
        late = sorted(run.lateness)
        ttft = sorted((r.times[0] - r.due) * 1e3 for r in due if r.times)
        if ttft:
            at = [ttft[min(len(ttft) - 1, int(q / 100 * len(ttft)))]
                  for q in (10, 25, 50, 75, 90, 95)]
            log("ttft ms over the window's requests: p10 p25 p50 p75 p90 "
                f"p95 {' '.join(f'{v:.1f}' for v in at)} n {len(ttft)}",
                file=sys.stderr)
        if late:
            log(f"generator lateness ms: p50 "
                f"{1e3 * late[len(late) // 2]:.3f} max "
                f"{1e3 * late[-1]:.3f} over {len(late)} requests",
                file=sys.stderr)
    else:
        attempted = sum(1 for r in run.recs if r.submit <= run.t_close
                        and (not r.times or r.times[-1] > run.t_open))
        failed = sum(1 for r in run.recs if r.engine_req().state.value in
                     ("failed", "expired", "cancelled"))
        ctx_len = [n for lens in run.decode_lengths.values() for n in lens]
        if ctx_len:
            log(f"window contexts: {len(run.decode_lengths)} rounds, "
                f"positions read per row min {min(ctx_len)} mean "
                f"{sum(ctx_len) / len(ctx_len):.1f} max {max(ctx_len)}; "
                f"rows per round {len(ctx_len) / len(run.decode_lengths):.2f}",
                file=sys.stderr)
    log("setup: " + " ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f" total {setup_s:.3f}", file=sys.stderr)

    # the program's state goes before the reference runs: the engine,
    # and its KV arena even if something still held the engine
    rounds_n = len(run.rounds)
    alive = weakref.ref(engine)
    engine.pool.arena = {}
    del engine, gen
    gc.unfreeze()
    gc.collect()
    drive.free_device()
    log(f"program state freed: {alive() is None}; "
        f"{torch.cuda.memory_allocated(dev) if dev.type == 'cuda' else 0}"
        f" bytes allocated", file=sys.stderr)
    readings = check.judge(run, params, dm, chunk, seed, mix["check"], dev,
                           control=control)
    limits = {k: float(cell.cell[k]) for k in GAP_NUMBERS
              if k in cell.cell}
    correct = (readings["requests"] > 0 and readings["wrong_length"] == 0
               and bool(limits)
               and all(readings[k] <= v for k, v in limits.items()))
    log(f"compared {readings['requests']} of {readings['finished']} "
        f"finished requests, {readings['tokens']} served tokens, "
        f"{rounds_n} rounds; readings: "
        + " ".join(f"{k} {v!r}" for k, v in readings.items()
                   if "gap" in k), file=sys.stderr)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result: Dict[str, Any] = {"correct": bool(correct),
                              "attempted": attempted, "failed": failed,
                              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s if summary else 0.0
        device_info["window_s"] = summary.window_s if summary else 0.0
        if summary is not None:
            result["breakdown"] = tracing.breakdown(summary)
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in limits.items()}
    checks["wrong_length"] = {"value": readings["wrong_length"],
                              "limit": 0}
    if control is not None:
        result["program"] = {k: readings["program_" + k]
                             for k in GAP_NUMBERS}
    result["checks"] = checks
    return result


def main(argv=None, device: str = "cuda", root: Optional[Path] = None
         ) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root or spec.ROOT)
    cell = spec.load_cell(args.workload, root)
    if device == "cuda":
        import torch
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < cell.chips:
            print(f"needs {cell.chips} CUDA device(s); found {found}",
                  file=sys.stderr)
            return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device=device, root=root)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
