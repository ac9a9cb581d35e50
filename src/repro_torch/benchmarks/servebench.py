"""Serving benchmark: legacy per-request loop vs slot-pool batching.

Counterpart of ``benchmarks/servebench.py``: the same rows, keys, traces
(the same numpy draws in the same order), flags, defaults and output
files, over the port's engine on the card (``--device cuda``, the
default, which raises without one) or on the CPU (``--device cpu``, the
kernels' plain versions). It measures tokens/s and queue-wait
percentiles (p50/p99) under Poisson arrivals at several concurrency
budgets K, for

  * ``legacy``  — the old per-request decode loop (sequential),
  * ``slots``   — the semaphore-gated continuous-batching slot engine,
  * ``paged``   — the same engine on the block-table page arena, lazy
    growth, always beside its eager (worst-case reservation) baseline on
    the same trace, with the allocator lock ledger,

plus the Algorithm-5 planned wait percentiles for the same trace, and
the dedicated traces: ``paged_prefix`` (prefix sharing on vs off),
``paged_fused`` (gather vs the fused decode kernel, bucketed dispatch),
``interleaved`` (chunked vs one-shot prefill), the multi-turn prefix
cache (``BENCH_prefix_cache.json``), chaos (``BENCH_chaos.json``) and
the open loop through the asyncio front-end (``BENCH_frontend.json``).

    PYTHONPATH=src python -m repro_torch.benchmarks.servebench --smoke \\
        --device cpu --kv-layout both --prefix-sharing both

Differences from the reference, all deliberate:

* **Trace counters.** The reference's ``dispatch_traces`` and
  ``dispatch_retraces`` count jit traces of its bucketed round wrapper.
  Eager PyTorch traces nothing, so both are ``null`` here — a copied or
  zero count would claim a trace that never happened.
  ``dispatch_trace_keys`` is the number of distinct dispatch shapes the
  engine ran (``stats()["dispatch_shapes"]``), which equals the
  reference's distinct trace keys on the same trace.
* **The jit-cache gate** of :func:`ci_gates` therefore reads
  ``0 < dispatch_trace_keys <= 2 * (floor(log2 K) + 1)``: the bound on
  the shape set (``log2 K + 1`` occupancy buckets times the ``chunk in
  {0, C}`` variants) that the reference's retrace gate exists to hold.
* **Timing.** On the card every timed region closes with a
  ``torch.cuda.synchronize()`` before its clock read, and both serving
  kernels are built before the first row, so no build falls in a timed
  region.
* ``seed`` seeds the weights (``model.init`` on a
  ``torch.Generator``), the trace draws and the open loop's arrivals;
  the port's engine is greedy only and draws nothing from it.

The port's additions to the flags: ``--device``; ``--full-width``
(published widths in the config's bf16 instead of ``cfg.reduced()`` in
float32 — the stream-equality flags ``eager_lazy_tokens_match``,
``tokens_match_*`` and the survivor matches then hold the share of
tokens equal instead of a bool, since a bf16 argmax flips with the
batch and chunk shapes; :func:`ci_gates` is for the float32 run). A
caller that needs only some rows at full width runs them through the
row functions (:func:`bench_legacy`, :func:`bench_slot_engine`,
:func:`fused_run`, :func:`interleaved_run`, :func:`open_loop_row`) on
``parser()``'s parsed args, which draw the traces ``main`` draws.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def poisson_arrival_steps(n: int, capacity: int, new_tokens: int,
                          load: float, rng) -> np.ndarray:
    """Arrival step-times for offered load ``load`` (fraction of replica
    token throughput: rate = load * K / service_steps)."""
    rate = load * capacity / float(new_tokens)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def shared_prefix_prompts(n: int, prompt_len: int, n_groups: int,
                          vocab: int, rng) -> np.ndarray:
    """The prefix-sharing arrival trace's prompts: ``n_groups`` distinct
    random prompts, each repeated round-robin — every follower's prompt
    is a full-length repeat of a live leader's, the workload shape of
    shared system preambles / few-shot headers."""
    base = rng.integers(0, vocab, (n_groups, prompt_len)).astype(np.int32)
    return base[np.arange(n) % n_groups]


def staggered_arrivals(n: int, n_groups: int, decode_chunk: int
                       ) -> np.ndarray:
    """Round-robin waves: one request per group per scheduler round
    (``decode_chunk`` steps), so every follower's admission finds the
    previous member of its group still decoding — a live donor — as
    long as ``n_groups`` leaves slot headroom (the trace runner keeps
    ``n_groups <= capacity / 2``)."""
    return (decode_chunk * (np.arange(n) // n_groups)).astype(np.int64)


def closed_loop_trace(seed: int, requests: int, prompt_len: int,
                      vocab: int, capacities, new_tokens: int,
                      load: float):
    """The closed-loop rows' trace: prompts, then the arrivals for each
    capacity in order, from one ``default_rng(seed)`` — the reference
    ``main``'s draws in its order. Returns ``(prompts, {k: arrivals})``."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, (requests, prompt_len)).astype(np.int32)
    arrivals = {k: poisson_arrival_steps(requests, k, new_tokens, load, rng)
                for k in capacities}
    return prompts, arrivals


def synchronize(device) -> None:
    """Wait for the card before a clock read closes a timed region."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_kernels(device) -> None:
    """Build both serving kernels (one ``nvcc`` each, in parallel)
    before any timed region; nothing to build off the card."""
    if torch.device(device).type != "cuda":
        return
    from repro_torch.kernels.build import build
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    build([PAGED_DECODE.source, SEMAPHORE_ADMISSION.source])


def token_share(pairs) -> float:
    """Share of the tokens of the first stream of each pair equal,
    position by position, to the second's (1.0 for no tokens)."""
    total = same = 0
    for a, b in pairs:
        a, b = list(a), list(b or [])
        total += len(a)
        same += sum(x == y for x, y in zip(a, b))
    return same / total if total else 1.0


def streams_match(a: Dict, b: Dict, exact: bool = True):
    """``a == b`` for ``{rid: tokens}`` streams, or with ``exact``
    False the share of ``a``'s tokens equal to ``b``'s."""
    if exact:
        return bool(a == b)
    return token_share((v, b.get(rid)) for rid, v in a.items())


def bench_slot_engine(model, params, prompts, arrivals, *, capacity,
                      new_tokens, decode_chunk, seed, kv_layout="slots",
                      page_size=16, page_growth="lazy",
                      allocator_wait=None, prefix_sharing="auto",
                      prefill_chunk_tokens=None, round_token_budget=None,
                      num_pages=None, attention_impl="gather",
                      bucketed_dispatch="auto", device=None):
    from repro_torch.serve.engine import SlotServeEngine
    # ``prompts`` may be a rectangular [n, L] array or a list of 1-D
    # arrays of different lengths (the interleaved trace mixes long
    # prompts with short ones)
    n = len(prompts)
    prompt_len = max(int(np.asarray(p).size) for p in prompts)
    max_len = prompt_len + new_tokens + 1
    engine = SlotServeEngine(model, params, capacity=capacity,
                             max_len=max_len, decode_chunk=decode_chunk,
                             kv_layout=kv_layout,
                             page_size=page_size, page_growth=page_growth,
                             allocator_wait=allocator_wait,
                             prefix_sharing=prefix_sharing,
                             prefill_chunk_tokens=prefill_chunk_tokens,
                             round_token_budget=round_token_budget,
                             num_pages=num_pages,
                             attention_impl=attention_impl,
                             bucketed_dispatch=bucketed_dispatch,
                             device=device)
    # warm outside the timed region on the longest prompt (its chunked
    # rounds run both chunk=C and chunk=0), then reset every counter the
    # report reads (step clock included, so the arrival schedule starts
    # at 0)
    warm = max(prompts, key=lambda p: np.asarray(p).size)
    engine.submit(warm, max_new_tokens=min(2, new_tokens))
    engine.run_until_done()
    engine.finished.clear()
    engine.grant_log.clear()
    engine.decode_dispatches = 0
    engine.step_clock = 0
    engine.pauses = engine.preemptions = 0
    engine.prefix_hits = engine.shared_pages_adopted = 0
    engine.cow_splits = 0
    engine.prefill_tokens = engine.pad_tokens = 0
    engine.prefill_chunks = 0
    engine.decode_rounds_stalled_by_prefill = 0
    engine.admission.admitted = engine.admission.completed = 0
    if kv_layout == "paged":
        engine.pool.pages.reset_stats()
    synchronize(engine.device)

    t0 = time.perf_counter()
    nxt = 0
    while nxt < n or engine.queue or engine.active:
        while nxt < n and arrivals[nxt] <= engine.step_clock:
            engine.submit(prompts[nxt], new_tokens)
            nxt += 1
        if engine.step() == 0 and not engine.queue and nxt < n:
            engine.step_clock += 1          # idle tick until next arrival
    synchronize(engine.device)
    dt = time.perf_counter() - t0
    st = engine.stats()
    fifo_ok = engine.grant_log == sorted(engine.grant_log)
    row = {
        "tokens": int(st["tokens"]),
        "wall_s": dt,
        "tok_per_s": st["tokens"] / dt,
        "p50_wait_steps": st["p50_wait_steps"],
        "p99_wait_steps": st["p99_wait_steps"],
        "p50_wait_s": st["p50_wait_s"],
        "p99_wait_s": st["p99_wait_s"],
        "decode_dispatches": int(st["decode_dispatches"]),
        "fifo_ok": bool(fifo_ok),
        # chunked-prefill ledger (one-shot rows report it too: their
        # pad tokens are the bucket padding chunking exists to shed)
        "prefill_chunk_tokens": int(st["prefill_chunk_tokens"]),
        "prefill_tokens": int(st["prefill_tokens"]),
        "pad_tokens": int(st["pad_tokens"]),
        "pad_fraction": float(st["pad_fraction"]),
        "prefill_chunks": int(st["prefill_chunks"]),
        "decode_rounds_stalled_by_prefill": int(
            st["decode_rounds_stalled_by_prefill"]),
        # read path + bucketed-dispatch ledger: no jit, so no trace
        # counts; the distinct dispatch shapes stand for the trace keys
        "attention_impl": engine.attention_impl,
        "bucketed_dispatch": bool(engine.bucketed_dispatch),
        "dispatch_traces": None,
        "dispatch_trace_keys": int(st["dispatch_shapes"]),
        "dispatch_retraces": None,
    }
    streams = {r.rid: list(r.out_tokens) for r in engine.finished}
    if kv_layout == "paged":
        engine.pool.check()                  # leak-free after the drain
        row.update({
            "page_size": page_size,
            "page_growth": engine.page_growth,
            "allocator_wait": engine.pool.pages.wait_mode,
            "wait_strategy": engine.pool.pages.wait_strategy.value,
            "pages_total": int(st["pages_total"]),
            "pages_peak_in_use": int(st["pages_peak_in_use"]),
            "page_allocs": int(st["page_allocs"]),
            "page_frees": int(st["page_frees"]),
            "page_pauses": int(st["page_pauses"]),
            "page_preemptions": int(st["page_preemptions"]),
            "lock_acquires": int(st["lock_acquires"]),
            "lock_contended_acquires": int(st["lock_contended_acquires"]),
            "lock_held_s": float(st["lock_held_s"]),
            "lock_acquires_per_token": float(st["lock_acquires_per_token"]),
            # the per-page accounting the lock-drop gate benchmarks
            # against: one lock acquisition per page moved
            "per_page_lock_acquires_per_token": float(
                st["per_page_lock_acquires_per_token"]),
            # prefix sharing's ledger
            "prefix_sharing": bool(engine.prefix_sharing),
            "pages_alloced": int(st["pages_alloced"]),
            "pages_per_token": float(st["pages_per_token"]),
            "prefix_hits": int(st["prefix_hits"]),
            "shared_pages_adopted": int(st["shared_pages_adopted"]),
            "cow_splits": int(st["cow_splits"]),
        })
    return row, streams


def bench_open_loop(model, params, prompts, closed_streams, *, capacity,
                    new_tokens, decode_chunk, seed, page_size,
                    prefix_sharing, prefill_chunk_tokens, cancel_every,
                    cancel_after_tokens, arrival_rate, slo_ms,
                    intake_limit=256, device=None, exact=True):
    """Open-loop trace through the asyncio front-end: Poisson wall-clock
    arrivals, token streaming, every ``cancel_every``-th client hanging
    up after ``cancel_after_tokens`` streamed tokens. ``engine.step``
    runs in the front-end's executor thread.

    ``closed_streams`` are the closed-loop driver's per-prompt greedy
    streams on the identical engine config; survivors must match them
    (with ``exact`` False the row holds the share of survivor tokens
    that do).
    """
    from repro_torch.serve.engine import RequestState, SlotServeEngine
    from repro_torch.serve.frontend import AsyncFrontend, IntakeFullError

    n = len(prompts)
    prompt_len = max(int(np.asarray(p).size) for p in prompts)
    max_len = prompt_len + new_tokens + 1
    engine = SlotServeEngine(model, params, capacity=capacity,
                             max_len=max_len, decode_chunk=decode_chunk,
                             kv_layout="paged", page_size=page_size,
                             prefix_sharing=prefix_sharing,
                             prefill_chunk_tokens=prefill_chunk_tokens,
                             device=device)
    # warm so TTFT measures scheduling, not first-use costs
    warm = max(prompts, key=lambda p: np.asarray(p).size)
    engine.submit(warm, max_new_tokens=min(2, new_tokens))
    engine.run_until_done()
    engine.finished.clear()
    engine.grant_log.clear()
    engine.decode_dispatches = 0
    engine.step_clock = 0
    engine.cancellations = engine.expiries = 0
    engine.pool.pages.reset_stats()
    synchronize(engine.device)

    rng = np.random.default_rng(seed + 3)
    gaps_s = rng.exponential(1.0 / arrival_rate, n)
    cancels = {i for i in range(n)
               if cancel_every and i % cancel_every == cancel_every - 1}
    records = []

    async def client(fe, i, prompt):
        rec = {"i": i, "tokens": [], "handle": None, "shed": False}
        records.append(rec)
        try:
            h = await fe.submit(prompt, new_tokens)
        except IntakeFullError:
            rec["shed"] = True
            return
        rec["handle"] = h
        async for tok in h:
            rec["tokens"].append(tok)

    # hang up once the client has its tokens-in-hand quota, from the
    # between-rounds hook so every cancel lands mid-flight
    async def hook(fe):
        for rec in records:
            h = rec["handle"]
            if (h is not None and rec["i"] in cancels
                    and h._streamed >= cancel_after_tokens
                    and not h._cancel_requested):
                h.cancel()

    async def drive():
        async with AsyncFrontend(engine, intake_limit=intake_limit,
                                 round_hook=hook) as fe:
            tasks = []
            for i, prompt in enumerate(prompts):
                await asyncio.sleep(gaps_s[i])
                tasks.append(asyncio.ensure_future(client(fe, i, prompt)))
            await asyncio.gather(*tasks)
            await fe.drain()
            return fe

    t0 = time.perf_counter()
    fe = asyncio.run(drive())
    synchronize(engine.device)
    wall_s = time.perf_counter() - t0

    # cancellation safety: the drained arena must be exactly full again
    engine.pool.pages.check()
    leaked = engine.pool.pages.num_pages - engine.pool.pages.n_free

    # survivors = clients that never asked to cancel
    survivors = [rec for rec in records
                 if rec["i"] not in cancels
                 and rec["handle"] is not None
                 and rec["handle"].state is RequestState.FINISHED]
    if exact:
        survivors_match = all(rec["tokens"] == closed_streams[rec["i"]]
                              for rec in survivors)
    else:
        survivors_match = token_share((rec["tokens"], closed_streams[rec["i"]])
                                      for rec in survivors)
    ttfts = sorted(r["handle"].ttft_s for r in records
                   if r["handle"] is not None
                   and r["handle"].ttft_s is not None)
    slo_s = slo_ms / 1e3
    good_tokens = sum(
        len(r["tokens"]) for r in records
        if r["handle"] is not None
        and r["handle"].state is RequestState.FINISHED
        and r["handle"].ttft_s is not None
        and r["handle"].ttft_s <= slo_s)
    st = fe.stats()
    return {
        "requests": n,
        "capacity": capacity,
        "arrival_rate": arrival_rate,
        "cancel_every": cancel_every,
        "wall_s": wall_s,
        "rounds": int(st["frontend_rounds"]),
        "finished": int(st["finished"]),
        "cancelled": int(st["cancelled"]),
        "expired": int(st["expired"]),
        "shed": int(st["frontend_shed"]),
        "tokens": int(st["tokens"]),
        "tok_per_s": st["tokens"] / wall_s,
        "goodput_tok_per_s": good_tokens / wall_s,
        "slo_ms": slo_ms,
        "slo_attainment": (len([t for t in ttfts if t <= slo_s])
                           / max(len(ttfts), 1)),
        "ttft_p50_ms": (1e3 * float(np.median(ttfts)) if ttfts
                        else float("nan")),
        "ttft_p99_ms": (1e3 * float(np.percentile(ttfts, 99)) if ttfts
                        else float("nan")),
        "p99_queued_steps": float(st["p99_queued_steps"]),
        "p99_prefill_steps": float(st["p99_prefill_steps"]),
        "p99_decode_steps": float(st["p99_decode_steps"]),
        "prefix_hits": int(st["prefix_hits"]),
        "leaked_pages": int(leaked),
        "survivor_streams_match_closed_loop": survivors_match,
        "fifo_ok": bool(engine.grant_log == sorted(engine.grant_log)),
    }


def open_loop_row(model, params, args, vocab, *, closed_streams=None,
                  device=None, exact=True):
    """The open-loop trace as ``main`` runs it from its parsed ``args``:
    shared-prefix prompts (``default_rng(seed + 4)``) at the largest
    capacity, then :func:`bench_open_loop` with sharing on and one page
    per prefill chunk. Its reference streams come from the closed-loop
    driver on the identical engine config, run first (its tokens/s in
    ``closed_loop_tok_per_s``) unless ``closed_streams`` — this
    function's own from an earlier call on the same trace — are given.
    Returns ``(row, closed_streams)``."""
    k = max(args.capacities)
    groups = max(1, min(args.prefix_groups, k // 2, args.requests))
    # >= 4 decode rounds, so a streaming client can cancel while its
    # request is still in flight
    new_tokens = max(4 * args.decode_chunk, args.new_tokens)
    prompts = shared_prefix_prompts(
        args.requests, args.prompt_len, groups, vocab,
        np.random.default_rng(args.seed + 4))
    closed = None
    if closed_streams is None:
        closed, streams = bench_slot_engine(
            model, params, prompts, np.zeros(args.requests), capacity=k,
            new_tokens=new_tokens, decode_chunk=args.decode_chunk,
            seed=args.seed, kv_layout="paged", page_size=args.page_size,
            prefix_sharing="on", prefill_chunk_tokens=args.page_size,
            device=device)
        # streams are keyed by rid in submission order (the warm-up
        # request holds the lowest rid and was cleared from finished)
        closed_streams = [streams[r] for r in sorted(streams)]
    row = bench_open_loop(
        model, params, list(prompts), closed_streams, capacity=k,
        new_tokens=new_tokens, decode_chunk=args.decode_chunk,
        seed=args.seed, page_size=args.page_size, prefix_sharing="on",
        prefill_chunk_tokens=args.page_size, cancel_every=args.cancel_every,
        cancel_after_tokens=args.cancel_after_tokens,
        arrival_rate=args.arrival_rate, slo_ms=args.slo_ms, device=device,
        exact=exact)
    if closed is not None:
        row["closed_loop_tok_per_s"] = closed["tok_per_s"]
    return row, closed_streams


def fused_run(model, params, prompts, args, impl, *, device=None):
    """One run of the fused trace as ``main`` runs it from its parsed
    ``args``: the closed-loop ``prompts`` at the largest capacity on
    Poisson arrivals from ``default_rng(seed + 5)``, chunked prefill of
    two pages, decode through ``impl`` (``"gather"`` or ``"fused"``).
    Returns ``(row, streams)``."""
    k = max(args.capacities)
    arrivals = poisson_arrival_steps(
        args.requests, k, args.new_tokens, max(args.load, 1.0),
        np.random.default_rng(args.seed + 5))
    return bench_slot_engine(
        model, params, prompts, arrivals, capacity=k,
        new_tokens=args.new_tokens, decode_chunk=args.decode_chunk,
        seed=args.seed, kv_layout="paged", page_size=args.page_size,
        page_growth=args.page_growth, allocator_wait=args.allocator_wait,
        prefill_chunk_tokens=2 * args.page_size, attention_impl=impl,
        device=device)


def interleaved_trace(args, vocab) -> Dict:
    """The interleaved trace from ``main``'s parsed ``args``: long and
    short prompts alternating, then their Poisson arrivals, both from
    ``default_rng(seed + 2)``; the chunk, decode length and page budget
    the trace runs with."""
    k = max(args.capacities)
    long_len = (args.interleaved_long_len
                if args.interleaved_long_len else 5 * args.page_size)
    new_tokens = 2 * args.new_tokens
    rng = np.random.default_rng(args.seed + 2)
    prompts = [rng.integers(0, vocab, long_len if i % 2 == 0
                            else args.page_size).astype(np.int32)
               for i in range(args.requests)]
    arrivals = poisson_arrival_steps(args.requests, k, new_tokens,
                                     max(args.load, 1.2), rng)
    # 7/8 of the all-slots worst case: mild page pressure
    num_pages = (7 * k * ((long_len + new_tokens + 1 + args.page_size - 1)
                          // args.page_size)) // 8
    return {"prompts": prompts, "arrivals": arrivals, "long_len": long_len,
            "short_len": args.page_size, "chunk_tokens": 2 * args.page_size,
            "new_tokens": new_tokens, "num_pages": num_pages}


def interleaved_run(model, params, args, trace, mode, *, device=None):
    """One run of :func:`interleaved_trace`'s ``trace`` at the largest
    capacity, ``mode`` ``"chunked"`` or ``"unchunked"`` (one-shot)
    prefill. Returns ``(row, streams)``."""
    return bench_slot_engine(
        model, params, trace["prompts"], trace["arrivals"],
        capacity=max(args.capacities), new_tokens=trace["new_tokens"],
        decode_chunk=args.decode_chunk, seed=args.seed, kv_layout="paged",
        page_size=args.page_size, page_growth=args.page_growth,
        allocator_wait=args.allocator_wait, num_pages=trace["num_pages"],
        prefill_chunk_tokens=(trace["chunk_tokens"] if mode == "chunked"
                              else None),
        # this trace isolates chunked-vs-one-shot prefill; keep the
        # occupancy-bucket ladder out of it
        bucketed_dispatch="off", device=device)


def _cache_streams_match(on, off, exact):
    """The cache trace's streams on vs off: the same rids, prompts and
    outputs (or, with ``exact`` False, the share of on-tokens equal)."""
    if exact:
        return bool(set(on) == set(off) and all(
            np.array_equal(on[r]["prompt"], off[r]["prompt"])
            and on[r]["out"] == off[r]["out"] for r in on))
    return token_share((on[r]["out"], off[r]["out"] if r in off else [])
                       for r in on)


def bench_prefix_cache(model, params, *, capacity, decode_chunk, seed,
                       page_size, vocab, requests, fuzz_traces=0,
                       device=None, exact=True):
    """Multi-turn conversation trace, prefix cache on vs off: shared
    system prompts plus follow-up turns whose prompts embed the parent's
    actual reply (serve/fuzz.py). The identical trace runs with
    ``prefix_cache="on"`` and ``"off"``; the gates read the on-row's
    ledger: hits, prefill tokens saved, streams equal to the off run,
    zero leaked pages once the cache is dropped, lock acquires per
    token not above the off run's. ``fuzz_traces`` pool-level fuzz
    traces (PoolFuzzHarness) run alongside and report their pass count.
    """
    from repro_torch.serve.engine import SlotServeEngine
    from repro_torch.serve.fuzz import PoolFuzzHarness, drive_trace, gen_trace

    events = gen_trace(seed + 5, n_requests=requests, vocab=vocab,
                       max_prompt=12, max_new=6, n_system_prompts=2,
                       p_shared=0.85, p_multi_turn=0.5, p_cancel=0.0,
                       arrival_spread=4)
    results, rows = {}, {}
    for mode in ("on", "off"):
        engine = SlotServeEngine(model, params, capacity=capacity,
                                 max_len=160, decode_chunk=decode_chunk,
                                 kv_layout="paged",
                                 page_size=page_size, prefix_sharing="on",
                                 prefix_cache=mode,
                                 prefill_chunk_tokens=page_size,
                                 device=device)
        # warm, then zero every counter the gates read — the cache's own
        # ledger included (the warm request's retirement donates)
        warm = (np.arange(12, dtype=np.int32) % (vocab - 1)) + 1
        engine.submit(warm, max_new_tokens=2)
        engine.run_until_done()
        engine.finished.clear()
        engine.grant_log.clear()
        engine.decode_dispatches = 0
        engine.step_clock = 0
        engine.prefix_hits = engine.shared_pages_adopted = 0
        engine.cow_splits = 0
        engine.cache_hits = engine.cache_tokens_served = 0
        engine.prefill_tokens_saved = 0
        if engine.prefix_cache is not None:
            engine.drop_prefix_cache()
            pc = engine.prefix_cache
            pc.hits = pc.misses = 0
            pc.pages_donated = pc.pages_duplicate = 0
            pc.pages_evicted = pc.pages_adopted = 0
        engine.pool.pages.reset_stats()
        synchronize(engine.device)

        t0 = time.perf_counter()
        trace_stats = {}
        results[mode] = drive_trace(engine, events,
                                    stats_out=trace_stats)
        synchronize(engine.device)
        dt = time.perf_counter() - t0
        st = engine.stats()
        rounds = max(trace_stats.get("rounds", 1), 1)
        # snapshot the lock ledger BEFORE dropping the cache (the drop's
        # free_batch takes the allocator lock too)
        acquires = engine.pool.pages.lock_stats()["acquires"]
        engine.pool.check()
        if engine.prefix_cache is not None:
            engine.drop_prefix_cache()
        row = {
            "tokens": int(st["tokens"]),
            "wall_s": dt,
            "tok_per_s": st["tokens"] / dt,
            "rounds": rounds,
            "lock_acquires": int(acquires),
            "lock_acquires_per_round": acquires / rounds,
            "lock_acquires_per_token": acquires / max(st["tokens"], 1),
            "prefix_hits": int(st["prefix_hits"]),
            "cache_hits": int(st["cache_hits"]),
            "cache_hit_rate": float(st["cache_hit_rate"]),
            "cache_tokens_served": int(st["cache_tokens_served"]),
            "prefill_tokens_saved": int(st["prefill_tokens_saved"]),
            "leaked_pages": int(engine.pool.pages.in_use),
            "fifo_ok": bool(engine.grant_log == sorted(engine.grant_log)),
        }
        if mode == "on":
            row.update({
                "cache_lookup_hits": int(st["cache_lookup_hits"]),
                "cache_pages_donated": int(st["cache_pages_donated"]),
                "cache_pages_adopted": int(st["cache_pages_adopted"]),
                "cache_pages_evicted": int(st["cache_pages_evicted"]),
            })
        rows[mode] = row

    on, off = rows["on"], rows["off"]
    on["tokens_match_off"] = _cache_streams_match(results["on"],
                                                  results["off"], exact)
    # identical token streams, so per-token acquires is the like-for-like
    # ratio (per round would penalize the cache for finishing sooner)
    on["lock_ratio_vs_off"] = (
        on["lock_acquires_per_token"] / off["lock_acquires_per_token"]
        if off["lock_acquires_per_token"] else float("inf"))
    on["lock_per_round_ratio_vs_off"] = (
        on["lock_acquires_per_round"] / off["lock_acquires_per_round"]
        if off["lock_acquires_per_round"] else float("inf"))

    passed = 0
    for fseed in range(fuzz_traces // 2):
        for cache in (True, False):
            PoolFuzzHarness(fseed, num_pages=48, page_size=page_size,
                            cache=cache).run(rounds=30)
            passed += 1
    on["fuzz_traces_passed"] = passed
    return {"capacity": capacity, "requests": requests,
            "page_size": page_size, **rows}


def bench_chaos(model, params, *, capacity, decode_chunk, seed, page_size,
                vocab, requests, fault_seed, alloc_rate, dispatch_rate,
                stuck_rate, max_faults, device=None, exact=True):
    """Chaos trace: the identical seeded conversation workload runs
    fault-free, under transient injected faults (allocator batch aborts
    mid-critical-section, dispatch exceptions, stuck lock holders), and
    with one request poisoned to fail deterministically. The gates:
    every fault kind fired, every fault recovered or quarantined, zero
    leaked pages, survivors equal to the fault-free run, lock acquires
    per token within 1.05x of it."""
    from repro_torch.serve.engine import RequestState, SlotServeEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fuzz import drive_trace, gen_trace

    def run(fault_plan):
        events = gen_trace(seed + 9, n_requests=requests, vocab=vocab,
                           max_prompt=12, max_new=10, n_system_prompts=2,
                           p_shared=0.7, p_multi_turn=0.4, p_cancel=0.0,
                           arrival_spread=4)
        engine = SlotServeEngine(
            model, params, capacity=capacity, max_len=160,
            decode_chunk=decode_chunk, kv_layout="paged",
            page_size=page_size, prefix_sharing="on", prefix_cache="on",
            prefill_chunk_tokens=page_size, fault_plan=fault_plan,
            quarantine_after=3, retry_backoff_s=0.0,
            allocator_watchdog_s=3e-3, device=device)
        t0 = time.perf_counter()
        streams = drive_trace(engine, events)
        synchronize(engine.device)
        dt = time.perf_counter() - t0
        st = engine.stats()
        acquires = engine.pool.pages.lock_stats()["acquires"]
        engine.drop_prefix_cache()
        engine.pool.check()
        finished = int(st["finished"])
        quarantined = int(st["requests_quarantined"])
        row = {
            "tokens": int(st["tokens"]),
            "wall_s": dt,
            "tok_per_s": st["tokens"] / dt,
            "finished": finished,
            "failed": int(st["failed"]),
            "faults_injected": int(st["faults_injected"]),
            "faults_by_kind": (dict(fault_plan.by_kind)
                               if fault_plan is not None else {}),
            "rounds_retried": int(st["rounds_retried"]),
            "requests_quarantined": quarantined,
            "watchdog_trips": int(st["watchdog_trips"]),
            "aborted_batches": int(st["aborted_batches"]),
            "availability": finished / max(finished + quarantined, 1),
            "lock_acquires": int(acquires),
            "lock_acquires_per_token": acquires / max(st["tokens"], 1),
            "leaked_pages": int(engine.pool.pages.in_use),
        }
        return row, streams, engine

    def survivors_match(base_streams, streams):
        """Over every request both runs served to completion from the
        same resolved prompt: (count, equal?) — or, with ``exact``
        False, (count, share of tokens equal)."""
        pairs = []
        for rid, a in base_streams.items():
            b = streams.get(rid)
            if b is None or a["cancelled"] or b["cancelled"]:
                continue
            if not np.array_equal(a["prompt"], b["prompt"]):
                continue
            if exact and a["out"] != b["out"]:
                return len(pairs), False
            pairs.append((a["out"], b["out"]))
        return len(pairs), (True if exact else token_share(pairs))

    base_row, base_streams, _ = run(None)

    # high per-consult rates so every kind reliably fires, bounded per
    # kind: allocator aborts are the only kind whose recovery re-takes
    # the lock, so they get the tightest cap
    chaos_plan = FaultPlan(fault_seed, alloc_rate=alloc_rate,
                           dispatch_rate=dispatch_rate,
                           stuck_rate=stuck_rate, stuck_hold_s=1e-2,
                           max_faults=max_faults,
                           max_per_kind={"alloc": 1, "dispatch": 2,
                                         "stuck": 2})
    chaos_row, chaos_streams, _ = run(chaos_plan)
    n, ok = survivors_match(base_streams, chaos_streams)
    chaos_row["survivors_compared"] = n
    chaos_row["survivor_streams_match_baseline"] = ok
    chaos_row["lock_ratio_vs_baseline"] = (
        chaos_row["lock_acquires_per_token"]
        / base_row["lock_acquires_per_token"]
        if base_row["lock_acquires_per_token"] else float("inf"))

    # poison a mid-trace request: it must be quarantined alone
    poison_rid = 1 + requests // 2
    poison_plan = FaultPlan(fault_seed, poison_rid=poison_rid)
    poison_row, poison_streams, eng = run(poison_plan)
    n, ok = survivors_match(base_streams, poison_streams)
    poison_row["survivors_compared"] = n
    poison_row["survivor_streams_match_baseline"] = ok
    poison_row["poison_rid"] = poison_rid
    failed = [r for r in eng.finished if r.state is RequestState.FAILED]
    poison_row["failed_rids"] = [r.rid for r in failed]
    poison_row["failed_error"] = failed[0].error if failed else None

    return {"capacity": capacity, "requests": requests,
            "fault_seed": fault_seed, "alloc_rate": alloc_rate,
            "dispatch_rate": dispatch_rate, "stuck_rate": stuck_rate,
            "baseline": base_row, "chaos": chaos_row,
            "poison": poison_row}


def bench_legacy(model, params, prompts, *, new_tokens, device=None):
    from repro_torch.serve.engine import ServeEngine
    dev = resolve_device(device)
    n, prompt_len = prompts.shape
    max_len = prompt_len + new_tokens + 1
    engine = ServeEngine(model, params, max_len=max_len)

    def batch(i):
        return {"tokens": torch.as_tensor(prompts[i], device=dev)[None, :]}

    engine.generate(batch(0), 2)  # warm
    synchronize(dev)

    t0 = time.perf_counter()
    waits, tokens = [], 0
    for i in range(n):
        synchronize(dev)
        waits.append(time.perf_counter() - t0)   # all arrive at t=0
        out = engine.generate(batch(i), new_tokens)
        tokens += int(out.tokens.numel())
    synchronize(dev)
    dt = time.perf_counter() - t0
    return {
        "tokens": tokens,
        "wall_s": dt,
        "tok_per_s": tokens / dt,
        "p50_wait_s": float(np.median(waits)),
        "p99_wait_s": float(np.percentile(waits, 99)),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published widths in the config's "
                         "dtype (bf16) instead of cfg.reduced() in float32; "
                         "stream-equality flags become token shares")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--capacities", type=int, nargs="+",
                    default=[1, 4, 8])
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--kv-layout", default="both",
                    choices=("slots", "paged", "both"),
                    help="which KV arena layout(s) to measure")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--page-growth", default="lazy",
                    choices=("lazy", "eager"),
                    help="paged-layout reservation policy for the main "
                         "paged rows (the eager baseline is always "
                         "measured alongside for the lock-traffic drop)")
    ap.add_argument("--allocator-wait", default=None,
                    choices=("auto", "spin", "spin_backoff",
                             "sleeping", "adaptive"),
                    help="pin the page allocator's wait strategy "
                         "(default: select_impl's choice)")
    ap.add_argument("--prefix-sharing", default="both",
                    choices=("on", "off", "both"),
                    help="which sharing modes the shared-prefix trace "
                         "measures ('both' adds the on-vs-off deltas the "
                         "gate asserts)")
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="distinct prompts in the shared-prefix trace "
                         "(every other request repeats one of them)")
    ap.add_argument("--chunked-prefill", default="both",
                    choices=("on", "off", "both"),
                    help="which prefill schedules the interleaved-arrivals "
                         "trace measures (paged layout only; 'both' adds "
                         "the chunked-vs-one-shot deltas the gate asserts)")
    ap.add_argument("--interleaved-long-len", type=int, default=None,
                    help="long-prompt length for the interleaved trace "
                         "(default 5 pages; shorts are one page)")
    ap.add_argument("--prefix-cache", default="on", choices=("on", "off"),
                    help="run the multi-turn prefix-cache trace (paged "
                         "layout only; cache on vs off)")
    ap.add_argument("--cache-requests", type=int, default=10,
                    help="requests in the multi-turn cache trace")
    ap.add_argument("--cache-fuzz-traces", type=int, default=200,
                    help="pool-level lifecycle fuzz traces run alongside "
                         "the cache trace (half cache-on, half off)")
    ap.add_argument("--cache-out", default="BENCH_prefix_cache.json",
                    help="where the prefix-cache trace's report lands")
    ap.add_argument("--fused-attention", default="on",
                    choices=("on", "off"),
                    help="run the fused-vs-gather paged-decode trace: one "
                         "trace through both read paths, streams must "
                         "match and the dispatch-shape set stay bounded")
    ap.add_argument("--load", type=float, default=0.8)
    ap.add_argument("--open-loop", default="on", choices=("on", "off"),
                    help="run the open-loop front-end trace (Poisson "
                         "wall-clock arrivals + mid-flight cancellations)")
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="open-loop trace: mean wall-clock arrival "
                         "rate, requests/s")
    ap.add_argument("--cancel-every", type=int, default=3,
                    help="open-loop trace: every Nth client cancels "
                         "mid-generation (0 = nobody cancels)")
    ap.add_argument("--cancel-after-tokens", type=int, default=2,
                    help="open-loop trace: tokens a cancelling client "
                         "consumes before hanging up")
    ap.add_argument("--slo-ms", type=float, default=30000.0,
                    help="open-loop trace: TTFT SLO for the goodput split")
    ap.add_argument("--chaos", default="on", choices=("on", "off"),
                    help="run the fault-injection chaos trace (baseline / "
                         "transient faults / poisoned request)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultPlan seed for the chaos trace")
    ap.add_argument("--fault-rate", type=float, default=0.2,
                    help="per-consult probability for each transient "
                         "fault site; per-kind caps bound the totals")
    ap.add_argument("--chaos-requests", type=int, default=28,
                    help="root requests in the chaos trace (long enough "
                         "that the bounded fault budget amortizes under "
                         "the 1.05x lock gate)")
    ap.add_argument("--chaos-max-faults", type=int, default=6,
                    help="total injected-fault budget for the chaos trace")
    ap.add_argument("--chaos-out", default="BENCH_chaos.json",
                    help="chaos trace report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_serve.json")
    ap.add_argument("--frontend-out", default="BENCH_frontend.json",
                    help="where the open-loop trace's report lands")
    return ap


def _write(path, obj) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)
        print(f"# wrote {path}")


def main(argv=None, *, model=None, params=None):
    """Run the benchmark; returns the ``BENCH_serve.json`` rows (the
    cache, chaos and frontend reports under ``prefix_cache``, ``chaos``
    and ``frontend``). ``model`` / ``params`` replace the drawn weights
    (they must be the config's: reduced unless ``--full-width``)."""
    args = parser().parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve.scheduler import plan_admission

    device = resolve_device(args.device)
    exact = not args.full_width
    cfg = get_arch(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()  # the CPU smoke tier's config, in float32
    if args.smoke:
        args.requests = min(args.requests, 16)
        args.capacities = [1, 4]
        # oversubscribe slightly so admission/retire batches fill up
        args.load = max(args.load, 1.0)
    build_kernels(device)
    if model is None:
        model = build_model(cfg)
    if params is None:
        params = model.init(
            torch.Generator(device=device).manual_seed(args.seed), device)
    prompts, arrivals_by_k = closed_loop_trace(
        args.seed, args.requests, args.prompt_len, cfg.vocab_size,
        args.capacities, args.new_tokens, args.load)

    legacy = bench_legacy(model, params, prompts,
                          new_tokens=args.new_tokens, device=device)
    print(f"legacy_loop,tok_per_s={legacy['tok_per_s']:.1f},"
          f"p50_wait_s={legacy['p50_wait_s']:.2f},"
          f"p99_wait_s={legacy['p99_wait_s']:.2f}")

    layouts = (("slots", "paged") if args.kv_layout == "both"
               else (args.kv_layout,))
    rows = {"arch": cfg.name, "requests": args.requests,
            "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
            "decode_chunk": args.decode_chunk, "load": args.load,
            "page_size": args.page_size, "legacy": legacy}
    rows.update({layout: {} for layout in layouts})
    if "paged" in layouts:
        rows["paged_eager"] = {}
    for k in args.capacities:
        arrivals = arrivals_by_k[k]
        plan = plan_admission(arrivals.astype(np.float32),
                              np.full(args.requests, float(args.new_tokens),
                                      np.float32), k, device=device)
        for layout in layouts:
            got, streams = bench_slot_engine(
                model, params, prompts, arrivals, capacity=k,
                new_tokens=args.new_tokens, decode_chunk=args.decode_chunk,
                seed=args.seed, kv_layout=layout, page_size=args.page_size,
                page_growth=args.page_growth,
                allocator_wait=args.allocator_wait, device=device)
            got["plan_p50_wait_steps"] = plan.p50_wait
            got["plan_p99_wait_steps"] = plan.p99_wait
            got["speedup_vs_legacy"] = got["tok_per_s"] / legacy["tok_per_s"]
            extra = ""
            if layout == "paged":
                # the eager baseline on the same trace: streams must
                # match, and the lock-traffic drop is measured against it
                if args.page_growth == "eager":
                    eag, eag_streams = dict(got), streams
                else:
                    eag, eag_streams = bench_slot_engine(
                        model, params, prompts, arrivals, capacity=k,
                        new_tokens=args.new_tokens,
                        decode_chunk=args.decode_chunk, seed=args.seed,
                        kv_layout="paged", page_size=args.page_size,
                        page_growth="eager",
                        allocator_wait=args.allocator_wait, device=device)
                eag["plan_p50_wait_steps"] = plan.p50_wait
                eag["plan_p99_wait_steps"] = plan.p99_wait
                eag["speedup_vs_legacy"] = (eag["tok_per_s"]
                                            / legacy["tok_per_s"])
                rows["paged_eager"][str(k)] = eag
                got["eager_lazy_tokens_match"] = streams_match(
                    streams, eag_streams, exact)
                lat = got["lock_acquires_per_token"]
                got["lock_drop_vs_eager"] = (
                    eag["lock_acquires_per_token"] / lat if lat else
                    float("inf"))
                # worst-case reservation at insert, one lock acquisition
                # per page moved: the eager run's per-page ledger
                got["lock_drop_vs_pr3_per_page"] = (
                    eag["per_page_lock_acquires_per_token"] / lat if lat
                    else float("inf"))
                extra = (f",pages_peak={got['pages_peak_in_use']}"
                         f"/{got['pages_total']},"
                         f"growth={got['page_growth']},"
                         f"lock_per_tok={lat:.4f},"
                         f"drop_vs_eager={got['lock_drop_vs_eager']:.2f}x,"
                         f"drop_vs_pr3_per_page="
                         f"{got['lock_drop_vs_pr3_per_page']:.2f}x,"
                         f"tokens_match={got['eager_lazy_tokens_match']}")
            rows[layout][str(k)] = got
            print(f"{layout}_engine_K{k},tok_per_s={got['tok_per_s']:.1f},"
                  f"p50_wait_steps={got['p50_wait_steps']:.1f},"
                  f"p99_wait_steps={got['p99_wait_steps']:.1f},"
                  f"plan_p50={got['plan_p50_wait_steps']:.1f},"
                  f"plan_p99={got['plan_p99_wait_steps']:.1f},"
                  f"speedup={got['speedup_vs_legacy']:.2f}x,"
                  f"fifo_ok={got['fifo_ok']}{extra}")

    # ---- dedicated shared-prefix trace (prefix sharing on vs off) ----
    if "paged" in layouts and args.kv_layout != "slots":
        k = max(args.capacities)
        # half the slots serve leaders, half followers
        n_groups = max(1, min(args.prefix_groups, k // 2, args.requests))
        # an unaligned prompt puts its tail in a partial page, so every
        # adoption ends in a CoW split at the follower's first token
        sp_prompt_len = args.prompt_len + (args.prompt_len % args.page_size
                                           == 0)
        # long enough that page demand arises mid-flight
        sp_new_tokens = max(3 * args.new_tokens, 2 * args.decode_chunk)
        sp_prompts = shared_prefix_prompts(
            args.requests, sp_prompt_len, n_groups, cfg.vocab_size,
            np.random.default_rng(args.seed + 1))
        sp_arrivals = staggered_arrivals(args.requests, n_groups,
                                         args.decode_chunk)
        modes = (("on", "off") if args.prefix_sharing == "both"
                 else (args.prefix_sharing,))
        sp_rows, sp_streams = {}, {}
        for mode in modes:
            got, streams = bench_slot_engine(
                model, params, sp_prompts, sp_arrivals, capacity=k,
                new_tokens=sp_new_tokens, decode_chunk=args.decode_chunk,
                seed=args.seed, kv_layout="paged",
                page_size=args.page_size, page_growth=args.page_growth,
                allocator_wait=args.allocator_wait, prefix_sharing=mode,
                device=device)
            sp_rows[mode] = got
            sp_streams[mode] = streams
        if len(modes) == 2:
            on, off = sp_rows["on"], sp_rows["off"]
            on["tokens_match_off"] = streams_match(
                sp_streams["on"], sp_streams["off"], exact)
            on["pages_drop_vs_off"] = (
                off["pages_per_token"] / on["pages_per_token"]
                if on["pages_per_token"] else float("inf"))
            on["lock_ratio_vs_off"] = (
                on["lock_acquires_per_token"]
                / off["lock_acquires_per_token"]
                if off["lock_acquires_per_token"] else float("inf"))
        rows["paged_prefix"] = {"capacity": k, "groups": n_groups,
                                **sp_rows}
        for mode in modes:
            r = sp_rows[mode]
            extra = ""
            if mode == "on" and "pages_drop_vs_off" in r:
                extra = (f",pages_drop_vs_off={r['pages_drop_vs_off']:.2f}x,"
                         f"lock_ratio_vs_off={r['lock_ratio_vs_off']:.2f},"
                         f"tokens_match={r['tokens_match_off']}")
            print(f"paged_prefix_{mode}_K{k},"
                  f"tok_per_s={r['tok_per_s']:.1f},"
                  f"pages_per_token={r['pages_per_token']:.3f},"
                  f"lock_per_tok={r['lock_acquires_per_token']:.4f},"
                  f"prefix_hits={r['prefix_hits']},"
                  f"shared_pages={r['shared_pages_adopted']},"
                  f"cow_splits={r['cow_splits']}{extra}")

    # ---- fused paged-decode trace (gather vs fused read path) ----
    # The same arrival trace twice, switching only ``attention_impl``:
    # the fused kernel must reproduce the gather path's streams, and
    # bucketed dispatch runs under both with a bounded shape set.
    # Chunked prefill is on so both chunk in {0, C} variants run.
    if args.fused_attention == "on" and "paged" in layouts:
        k = max(args.capacities)
        fa_rows, fa_streams = {}, {}
        for impl in ("gather", "fused"):
            fa_rows[impl], fa_streams[impl] = fused_run(
                model, params, prompts, args, impl, device=device)
        fused = fa_rows["fused"]
        fused["tokens_match_gather"] = streams_match(
            fa_streams["fused"], fa_streams["gather"], exact)
        fused["wall_ratio_vs_gather"] = (
            fused["wall_s"] / fa_rows["gather"]["wall_s"]
            if fa_rows["gather"]["wall_s"] else float("inf"))
        rows["paged_fused"] = {"capacity": k, **fa_rows}
        for impl in ("gather", "fused"):
            r = fa_rows[impl]
            extra = ""
            if impl == "fused":
                extra = (f",tokens_match={r['tokens_match_gather']},"
                         f"wall_ratio={r['wall_ratio_vs_gather']:.2f}x")
            print(f"paged_{impl}_K{k},tok_per_s={r['tok_per_s']:.1f},"
                  f"dispatch_trace_keys={r['dispatch_trace_keys']}{extra}")

    # ---- interleaved-arrivals trace (chunked vs one-shot prefill) ----
    # Long prompts and short decodes interleaved on a page-tight arena;
    # the gate asserts the wall-clock p99 queue-wait drop at identical
    # streams with lock_acquires_per_token not increased.
    if "paged" in layouts and args.kv_layout != "slots":
        k = max(args.capacities)
        trace = interleaved_trace(args, cfg.vocab_size)
        modes = (("chunked", "unchunked") if args.chunked_prefill == "both"
                 else (("chunked",) if args.chunked_prefill == "on"
                       else ("unchunked",)))
        il_rows, il_streams = {}, {}
        for mode in modes:
            il_rows[mode], il_streams[mode] = interleaved_run(
                model, params, args, trace, mode, device=device)
        if len(modes) == 2:
            ch, un = il_rows["chunked"], il_rows["unchunked"]
            ch["tokens_match_unchunked"] = streams_match(
                il_streams["chunked"], il_streams["unchunked"], exact)
            # wall-clock: the step clock never charges one-shot mode for
            # its whole-prompt prefill dispatches inside admission
            ch["p99_wait_s_drop_vs_unchunked"] = (
                un["p99_wait_s"] / ch["p99_wait_s"]
                if ch["p99_wait_s"] else float("inf"))
            ch["lock_ratio_vs_unchunked"] = (
                ch["lock_acquires_per_token"]
                / un["lock_acquires_per_token"]
                if un["lock_acquires_per_token"] else float("inf"))
            ch["pad_fraction_unchunked"] = un["pad_fraction"]
        rows["interleaved"] = {"capacity": k, "long_len": trace["long_len"],
                               "short_len": trace["short_len"],
                               "chunk_tokens": trace["chunk_tokens"],
                               "num_pages": trace["num_pages"], **il_rows}
        for mode in modes:
            r = il_rows[mode]
            extra = ""
            if mode == "chunked" and "tokens_match_unchunked" in r:
                extra = (f",p99_s_drop="
                         f"{r['p99_wait_s_drop_vs_unchunked']:.2f}x,"
                         f"lock_ratio={r['lock_ratio_vs_unchunked']:.2f},"
                         f"tokens_match={r['tokens_match_unchunked']}")
            print(f"interleaved_{mode}_K{k},"
                  f"tok_per_s={r['tok_per_s']:.1f},"
                  f"p99_wait_s={r['p99_wait_s']:.3f},"
                  f"p99_wait_steps={r['p99_wait_steps']:.1f},"
                  f"pad_fraction={r['pad_fraction']:.3f},"
                  f"lock_per_tok={r['lock_acquires_per_token']:.4f},"
                  f"prefill_chunks={r['prefill_chunks']},"
                  f"stalled_rounds="
                  f"{r['decode_rounds_stalled_by_prefill']}{extra}")

    # ---- multi-turn prefix-cache trace (cache on vs off) ----
    if args.prefix_cache == "on" and "paged" in layouts:
        k = max(args.capacities)
        pc_row = bench_prefix_cache(
            model, params, capacity=k, decode_chunk=args.decode_chunk,
            seed=args.seed, page_size=args.page_size,
            vocab=cfg.vocab_size, requests=args.cache_requests,
            fuzz_traces=args.cache_fuzz_traces, device=device, exact=exact)
        rows["prefix_cache"] = pc_row
        on = pc_row["on"]
        print(f"prefix_cache_on_K{k},"
              f"cache_hits={on['cache_hits']},"
              f"hit_rate={on['cache_hit_rate']:.2f},"
              f"tokens_served={on['cache_tokens_served']},"
              f"prefill_saved={on['prefill_tokens_saved']},"
              f"pages_donated={on['cache_pages_donated']},"
              f"pages_evicted={on['cache_pages_evicted']},"
              f"lock_ratio_vs_off={on['lock_ratio_vs_off']:.2f},"
              f"tokens_match={on['tokens_match_off']},"
              f"leaked_pages={on['leaked_pages']},"
              f"fuzz_traces_passed={on['fuzz_traces_passed']},"
              f"fifo_ok={on['fifo_ok']}")
        _write(args.cache_out, pc_row)

    # ---- chaos trace (injected faults vs the fault-free baseline) ----
    if args.chaos == "on" and "paged" in layouts:
        k = max(args.capacities)
        chaos_row = bench_chaos(
            model, params, capacity=k, decode_chunk=args.decode_chunk,
            seed=args.seed, page_size=args.page_size,
            vocab=cfg.vocab_size, requests=args.chaos_requests,
            fault_seed=args.fault_seed, alloc_rate=args.fault_rate,
            dispatch_rate=args.fault_rate, stuck_rate=args.fault_rate,
            max_faults=args.chaos_max_faults, device=device, exact=exact)
        rows["chaos"] = chaos_row
        ch, po = chaos_row["chaos"], chaos_row["poison"]
        print(f"chaos_K{k},"
              f"faults={ch['faults_injected']},"
              f"by_kind={ch['faults_by_kind']},"
              f"retried={ch['rounds_retried']},"
              f"aborted_batches={ch['aborted_batches']},"
              f"watchdog_trips={ch['watchdog_trips']},"
              f"availability={ch['availability']:.2f},"
              f"lock_ratio={ch['lock_ratio_vs_baseline']:.3f},"
              f"survivors_match={ch['survivor_streams_match_baseline']},"
              f"leaked_pages={ch['leaked_pages']}")
        print(f"chaos_poison_K{k},"
              f"faults={po['faults_injected']},"
              f"quarantined={po['requests_quarantined']},"
              f"failed_rids={po['failed_rids']},"
              f"availability={po['availability']:.2f},"
              f"survivors_match={po['survivor_streams_match_baseline']},"
              f"leaked_pages={po['leaked_pages']}")
        _write(args.chaos_out, chaos_row)

    # ---- open-loop front-end trace (asyncio lifecycle, cancellations)
    if args.open_loop == "on" and "paged" in layouts:
        k = max(args.capacities)
        fe_row, _ = open_loop_row(model, params, args, cfg.vocab_size,
                                  device=device, exact=exact)
        rows["frontend"] = fe_row
        print(f"frontend_open_loop_K{k},"
              f"tok_per_s={fe_row['tok_per_s']:.1f},"
              f"goodput_tok_per_s={fe_row['goodput_tok_per_s']:.1f},"
              f"ttft_p50_ms={fe_row['ttft_p50_ms']:.0f},"
              f"ttft_p99_ms={fe_row['ttft_p99_ms']:.0f},"
              f"slo_attainment={fe_row['slo_attainment']:.2f},"
              f"cancelled={fe_row['cancelled']},"
              f"shed={fe_row['shed']},"
              f"leaked_pages={fe_row['leaked_pages']},"
              f"survivors_match="
              f"{fe_row['survivor_streams_match_closed_loop']},"
              f"fifo_ok={fe_row['fifo_ok']}")
        _write(args.frontend_out, fe_row)

    _write(args.out, rows)

    batched = [v for layout in layouts
               for kk, v in rows[layout].items() if int(kk) > 1]
    if batched and not all(v["speedup_vs_legacy"] > 1.0 for v in batched):
        print("# WARNING: batched engine not faster than legacy at K > 1")
    return rows


# ------------------------------------------------------------------ gates
#: the one gate step that reads a wall-clock ratio (see :func:`ci_gates`)
WALL_CLOCK_STEP = "interleaved wall clock"

#: key endings and fragments of the numbers a clock measures
TIMED_ENDINGS = ("wall_s", "_wait_s", "lock_held_s")
TIMED_FRAGMENTS = ("tok_per_s", "ttft_", "_wait_s_drop", "speedup_vs_legacy",
                   "wall_ratio_vs_gather", "slo_attainment")
#: counts a clock decides: critical sections held past the allocator
#: watchdog's 3 ms. A stuck holder always is; on a loaded host an
#: ordinary one can be too (the chaos row counted 3 trips for 2 stuck
#: holders in one of two packages' runs beside five busy test workers)
TIMED_COUNTS = ("watchdog_trips",)
#: the open loop's counts that follow its wall-clock arrivals (which
#: request a cancel catches, who shares whose pages, how many rounds)
OPEN_LOOP_CLOCKED = ("rounds", "finished", "cancelled", "expired", "shed",
                     "tokens", "prefix_hits", "p99_queued_steps",
                     "p99_prefill_steps", "p99_decode_steps")


def is_timed(key: str) -> bool:
    """Whether a report key holds a number a clock measured."""
    return key.endswith(TIMED_ENDINGS) or key in TIMED_COUNTS or any(
        t in key for t in TIMED_FRAGMENTS)


def untimed(report, open_loop: bool = False):
    """``report`` without the numbers a clock measures (:func:`is_timed`),
    and in the open loop's row (``open_loop``, or under a ``frontend``
    key) the clocked counts give way to their sum ``accounted`` —
    finished + cancelled + expired + shed, which must equal the
    clients."""
    if not isinstance(report, dict):
        return report
    out = {k: untimed(v, open_loop=(k == "frontend"))
           for k, v in report.items()
           if not is_timed(k) and not (open_loop and k in OPEN_LOOP_CLOCKED)}
    if open_loop:
        out["accounted"] = sum(report[k] for k in (
            "finished", "cancelled", "expired", "shed"))
    return out


def _gate(failed: List[str], ok, what: str) -> None:
    if not ok:
        failed.append(what)


def _gates_lock_traffic(serve, failed):
    paged = serve["paged"]
    _gate(failed, bool(paged), "lock traffic: no paged rows")
    drops = []
    for k, row in paged.items():
        _gate(failed, row["page_growth"] == "lazy",
              f"lock traffic K={k}: page_growth {row['page_growth']}")
        lat = row["lock_acquires_per_token"]
        _gate(failed, isinstance(lat, float) and math.isfinite(lat)
              and lat > 0, f"lock traffic K={k}: lock_acquires_per_token "
              f"{lat}")
        _gate(failed, row["eager_lazy_tokens_match"] is True,
              f"lock traffic K={k}: lazy token stream diverged from eager")
        drops.append(row["lock_drop_vs_pr3_per_page"])
    _gate(failed, bool(drops) and min(drops) >= 4.0,
          f"lock traffic: drop vs per-page baseline regressed: {drops}")


def _gates_prefix_sharing(serve, failed):
    on, off = serve["paged_prefix"]["on"], serve["paged_prefix"]["off"]
    _gate(failed, on["tokens_match_off"] is True,
          "prefix sharing: sharing changed a token stream")
    _gate(failed, on["prefix_hits"] > 0 and on["shared_pages_adopted"] > 0,
          f"prefix sharing: hits {on['prefix_hits']}, adopted "
          f"{on['shared_pages_adopted']}")
    _gate(failed, on["cow_splits"] > 0,
          "prefix sharing: trace never exercised a CoW split")
    _gate(failed, on["pages_alloced"] < off["pages_alloced"],
          f"prefix sharing: pages alloced {on['pages_alloced']} vs off "
          f"{off['pages_alloced']}")
    _gate(failed, on["lock_acquires_per_token"]
          <= off["lock_acquires_per_token"],
          f"prefix sharing: lock acquires per token "
          f"{on['lock_acquires_per_token']} vs off "
          f"{off['lock_acquires_per_token']}")


def _gates_interleaved(serve, failed):
    ch = serve["interleaved"]["chunked"]
    un = serve["interleaved"]["unchunked"]
    _gate(failed, ch["tokens_match_unchunked"] is True,
          "interleaved: chunked prefill changed a token stream")
    lr = ch["lock_ratio_vs_unchunked"]
    _gate(failed, lr <= 1.0,
          f"interleaved: chunking raised lock traffic per token: {lr:.3f}")
    _gate(failed, ch["pad_fraction"] < ch["pad_fraction_unchunked"],
          f"interleaved: pad fraction {ch['pad_fraction']} vs "
          f"{ch['pad_fraction_unchunked']}")
    _gate(failed, ch["decode_rounds_stalled_by_prefill"] == 0,
          f"interleaved: chunked stalled "
          f"{ch['decode_rounds_stalled_by_prefill']} decode rounds")
    _gate(failed, un["decode_rounds_stalled_by_prefill"] > 0,
          "interleaved: trace never stalled a decode round under one-shot "
          "prefill")


def _gates_interleaved_wall_clock(serve, failed):
    drop = serve["interleaved"]["chunked"]["p99_wait_s_drop_vs_unchunked"]
    _gate(failed, drop > 1.0, f"{WALL_CLOCK_STEP}: p99 queue wait did not "
          f"improve: {drop:.2f}x")


def _gates_prefix_cache(cache, failed):
    on = cache["on"]
    _gate(failed, on["cache_hits"] > 0 and on["cache_hit_rate"] > 0,
          f"prefix cache: hits {on['cache_hits']}, rate "
          f"{on['cache_hit_rate']}")
    _gate(failed, on["prefill_tokens_saved"] > 0,
          "prefix cache: no prefill chunk skipped")
    _gate(failed, on["tokens_match_off"] is True,
          "prefix cache: cache changed a token stream")
    _gate(failed, on["leaked_pages"] == 0,
          f"prefix cache: retained {on['leaked_pages']} pages past the drop")
    lr = on["lock_ratio_vs_off"]
    _gate(failed, lr <= 1.0,
          f"prefix cache: cache raised lock traffic per token: {lr:.3f}")
    _gate(failed, on["fuzz_traces_passed"] >= 200,
          f"prefix cache: fuzz traces passed {on['fuzz_traces_passed']}")
    _gate(failed, on["fifo_ok"],
          "prefix cache: cache adoption broke FIFO grant order")


def _gates_frontend(fe, failed):
    _gate(failed, fe["cancelled"] > 0, "open loop: trace never exercised a "
          "cancel")
    _gate(failed, fe["leaked_pages"] == 0,
          f"open loop: cancellation leaked {fe['leaked_pages']} pages")
    _gate(failed, fe["survivor_streams_match_closed_loop"] is True,
          "open loop: a survivor's stream diverged from the closed loop")
    _gate(failed, fe["fifo_ok"], "open loop: broke the FIFO grant order")
    g = fe["goodput_tok_per_s"]
    _gate(failed, isinstance(g, float) and math.isfinite(g) and g > 0,
          f"open loop: goodput {g}")
    for k in ("ttft_p50_ms", "ttft_p99_ms"):
        _gate(failed, math.isfinite(fe[k]) and fe[k] > 0,
              f"open loop: {k} {fe[k]}")


def _gates_chaos(cz, failed):
    ch, po, base = cz["chaos"], cz["poison"], cz["baseline"]
    _gate(failed, base["faults_injected"] == 0
          and base["watchdog_trips"] == 0,
          f"chaos: baseline faults {base['faults_injected']}, watchdog "
          f"trips {base['watchdog_trips']}")
    _gate(failed, ch["faults_injected"] > 0, "chaos: injected nothing")
    for kind in ("alloc", "dispatch", "stuck"):
        _gate(failed, ch["faults_by_kind"].get(kind, 0) > 0,
              f"chaos: fault kind never fired: {kind}")
    _gate(failed, ch["rounds_retried"] > 0 and ch["aborted_batches"] > 0,
          f"chaos: retried {ch['rounds_retried']}, aborted batches "
          f"{ch['aborted_batches']}")
    _gate(failed, ch["watchdog_trips"] > 0,
          "chaos: stuck holder never tripped the watchdog")
    _gate(failed, ch["requests_quarantined"] == 0
          and ch["availability"] == 1.0,
          f"chaos: quarantined {ch['requests_quarantined']}, availability "
          f"{ch['availability']}")
    _gate(failed, ch["survivor_streams_match_baseline"] is True,
          "chaos: a survivor's stream diverged under transient faults")
    lr = ch["lock_ratio_vs_baseline"]
    _gate(failed, lr <= 1.05,
          f"chaos: recovery raised lock traffic per token: {lr:.3f}")
    _gate(failed, po["requests_quarantined"] == 1
          and po["failed_rids"] == [po["poison_rid"]],
          f"chaos: poison quarantined {po['requests_quarantined']}, failed "
          f"{po['failed_rids']}, poison rid {po['poison_rid']}")
    _gate(failed, po["availability"] < 1.0,
          f"chaos: poison availability {po['availability']}")
    _gate(failed, "injected fault" in (po["failed_error"] or ""),
          f"chaos: poison error {po['failed_error']!r}")
    _gate(failed, po["survivor_streams_match_baseline"] is True,
          "chaos: a survivor's stream diverged after quarantine")
    for name, row in (("baseline", base), ("chaos", ch), ("poison", po)):
        _gate(failed, row["leaked_pages"] == 0,
              f"chaos: {name} leaked {row['leaked_pages']} pages")


def _gates_fused(serve, failed):
    pf = serve["paged_fused"]
    fused, gather = pf["fused"], pf["gather"]
    _gate(failed, fused["attention_impl"] == "fused",
          f"fused decode: attention_impl {fused['attention_impl']}")
    _gate(failed, fused["tokens_match_gather"] is True,
          "fused decode: fused kernel diverged from the gather streams")
    bound = 2 * (int(math.floor(math.log2(pf["capacity"]))) + 1)
    for name, row in (("fused", fused), ("gather", gather)):
        _gate(failed, row["bucketed_dispatch"],
              f"fused decode: {name}: bucketing stayed off")
        keys = row["dispatch_trace_keys"]
        _gate(failed, 0 < keys <= bound,
              f"fused decode: {name}: {keys} dispatch shapes, bound "
              f"{bound}")


def ci_gates(serve, cache, frontend, chaos) -> List[str]:
    """The reference CI's serving gates (``.github/workflows/ci.yml``,
    the steps after the serving benchmark) over the four reports: one
    string per failed gate, each led by its step's name, empty when
    every gate holds. A report that lacks a key a gate reads fails that
    gate's step.

    Transcribed as they are, but for the jit-cache gate: the reference
    asserts ``dispatch_retraces == 0`` and ``0 < dispatch_trace_keys <=
    dispatch_traces``, counts of jit traces the port does not make. It
    reads here ``0 < dispatch_trace_keys <= 2 * (floor(log2 K) + 1)``,
    the bound the reference states for its trace set (``log2 K + 1``
    occupancy buckets times the ``chunk in {0, C}`` variants); the CPU
    tests hold ``dispatch_trace_keys`` equal to the reference's.

    One gate reads the wall clock, not the schedule: the interleaved
    trace's p99 queue-wait drop (step :data:`WALL_CLOCK_STEP`). Every
    other gate reads counts and streams that equal the reference's on
    the same trace."""
    failed: List[str] = []
    for step, fn, report in (
            ("lock traffic", _gates_lock_traffic, serve),
            ("prefix sharing", _gates_prefix_sharing, serve),
            ("interleaved", _gates_interleaved, serve),
            (WALL_CLOCK_STEP, _gates_interleaved_wall_clock, serve),
            ("prefix cache", _gates_prefix_cache, cache),
            ("open loop", _gates_frontend, frontend),
            ("chaos", _gates_chaos, chaos),
            ("fused decode", _gates_fused, serve)):
        try:
            fn(report, failed)
        except (KeyError, TypeError) as e:
            failed.append(f"{step}: report lacks {e!r}")
    return failed


if __name__ == "__main__":
    main()
