"""Where the rounds of servebench's interleaved trace spend their wall
time, chunked vs one-shot prefill, in the JAX package and in the port,
on the CPU. Run from the repo root:

    PYTHONPATH=src python tests/interleaved_rounds.py

The trace is servebench's at the reference CI's command line
(``--smoke``: reduced qwen3-14b, float32, 16 requests alternating long
and short prompts, Poisson arrivals, capacity 4, page 16, a page-tight
arena, bucketing off), built by the port's ``interleaved_trace`` (held
equal to the JAX benchmark's by tests/test_torch_servebench.py) and run
by the benchmark's own loop: a warm request of the longest prompt, the
counters reset, then the timed run. Every engine method that does
device work is wrapped with a wall-clock timer that waits for its
result (``block_until_ready`` in JAX): the one-shot prefill, the round's
dispatch, and admission (``_admit``, its prefills left out). The rest of
``step`` (page prep, retirement, bookkeeping) is ``other``.

One JSON line per package and mode: seconds in each part, the calls of
the prefill and their slowest one (a compile lands there), the p99 wait
(s) and the drop the CI's wall-clock gate reads (one-shot p99 over
chunked p99).
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.benchmarks import servebench  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402


class Clock:
    """Seconds and calls per part; ``prefill_max`` the slowest prefill."""

    def __init__(self):
        self.s = {"prefill": 0.0, "dispatch": 0.0, "admission": 0.0,
                  "step": 0.0}
        self.calls = {k: 0 for k in self.s}
        self.prefill_max = 0.0
        self.on = False

    def timed(self, part, fn, wait):
        def run(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = wait(fn(*a, **kw))
            dt = time.perf_counter() - t0
            self.s[part] += dt
            self.calls[part] += 1
            if part == "prefill":
                self.prefill_max = max(self.prefill_max, dt)
            return out
        return run

    def report(self):
        other = self.s["step"] - self.s["admission"] - self.s["dispatch"]
        return {"seconds": {"prefill": self.s["prefill"],
                            "admission_without_prefill": (
                                self.s["admission"] - self.s["prefill"]),
                            "dispatch": self.s["dispatch"], "other": other,
                            "steps": self.s["step"]},
                "prefill_calls": self.calls["prefill"],
                "prefill_max_s": self.prefill_max,
                "rounds": self.calls["step"]}


def instrument(eng, clock, jax_engine):
    """Wrap the engine's device work on the instance."""
    if jax_engine:
        def wait(x):
            return jax.block_until_ready(x)
        names = {"prefill": ("_prefill",),
                 "dispatch": ("_chunk", "_round", "_bucket_chunk",
                              "_bucket_round")}
    else:
        def wait(x):
            return x
        names = {"prefill": ("_prefill_impl",), "dispatch": ("_dispatch",)}
    for part, attrs in names.items():
        for a in attrs:
            setattr(eng, a, clock.timed(part, getattr(eng, a), wait))
    eng._admit = clock.timed("admission", eng._admit, lambda x: x)
    eng.step = clock.timed("step", eng.step, lambda x: x)


def run(cls, model, params, trace, mode, extra, jax_engine):
    """servebench's ``bench_slot_engine`` loop on the interleaved trace,
    with the engine instrumented for the timed region only."""
    prompts, arrivals = trace["prompts"], trace["arrivals"]
    new_tokens = trace["new_tokens"]
    max_len = max(int(p.size) for p in prompts) + new_tokens + 1
    eng = cls(model, params, capacity=4, max_len=max_len, decode_chunk=1,
              seed=0, kv_layout="paged", page_size=16,
              num_pages=trace["num_pages"],
              prefill_chunk_tokens=(trace["chunk_tokens"]
                                    if mode == "chunked" else None),
              bucketed_dispatch="off", **extra)
    clock = Clock()
    instrument(eng, clock, jax_engine)
    warm = max(prompts, key=lambda p: p.size)
    eng.submit(warm, max_new_tokens=2)
    eng.run_until_done()
    eng.finished.clear()
    eng.grant_log.clear()
    eng.step_clock = 0
    clock.on = True
    t0 = time.perf_counter()
    nxt, n = 0, len(prompts)
    while nxt < n or eng.queue or eng.active:
        while nxt < n and arrivals[nxt] <= eng.step_clock:
            eng.submit(prompts[nxt], new_tokens)
            nxt += 1
        if eng.step() == 0 and not eng.queue and nxt < n:
            eng.step_clock += 1
    wall = time.perf_counter() - t0
    waits = [r.wait_s for r in eng.finished]
    return dict(clock.report(), wall_s=wall,
                p99_wait_s=float(np.percentile(waits, 99)),
                p99_wait_steps=float(np.percentile(
                    [r.wait_steps for r in eng.finished], 99)),
                streams=[list(r.out_tokens) for r in sorted(
                    eng.finished, key=lambda r: r.rid)])


def main():
    torch.set_num_threads(1)
    args = servebench.parser().parse_args(["--smoke"])
    args.requests, args.capacities = min(args.requests, 16), [1, 4]
    args.load = max(args.load, 1.0)
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(args.seed))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    trace = servebench.interleaved_trace(args, tm.cfg.vocab_size)
    out = {}
    for pkg, cls, m, p, extra, is_jax in (
            ("jax", jengine.SlotServeEngine, jm, jp, {}, True),
            ("torch", tengine.SlotServeEngine, tm, tp, {"device": "cpu"},
             False)):
        for mode in ("chunked", "unchunked"):
            out[(pkg, mode)] = run(cls, m, p, trace, mode, extra, is_jax)
    for pkg in ("jax", "torch"):
        ch, un = out[(pkg, "chunked")], out[(pkg, "unchunked")]
        for mode, r in (("chunked", ch), ("unchunked", un)):
            print(json.dumps({"package": pkg, "mode": mode,
                              **{k: v for k, v in r.items()
                                 if k != "streams"}}))
        print(json.dumps({"package": pkg,
                          "p99_wait_s_drop": un["p99_wait_s"]
                          / ch["p99_wait_s"],
                          "streams_equal_across_modes":
                              ch["streams"] == un["streams"]}))
    print(json.dumps({"streams_equal_across_packages": all(
        out[("jax", m)]["streams"] == out[("torch", m)]["streams"]
        for m in ("chunked", "unchunked"))}))


if __name__ == "__main__":
    main()
