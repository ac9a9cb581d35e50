"""Serving entry point: continuous batching behind the Algorithm-5
semaphore, closed loop or open loop (counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --smoke --requests 12 --capacity 4 --prompt-len 16 \\
        --new-tokens 8 --legacy --device cpu

One engine replica on the card (``--device cuda``, the default; ``--device
cpu`` runs the kernels' plain versions), with the reference launcher's
defaults: the contiguous slot arena (``--kv-layout slots``), one-shot
prefill at admission, two decode steps per dispatch, and the
Algorithm-5 semaphore kernel replanning admission every scheduler
round. ``--kv-layout paged`` swaps in the block-table page arena, whose
allocator runs under the Algorithm-3 ticket mutex (``--page-growth``,
``--page-size``, ``--attention-impl fused`` for the fused paged-decode
kernel); ``--prefill-chunk-tokens C`` prefills C prompt tokens per round
inside the decode dispatch instead. On the paged layout
``--prefix-sharing`` (default ``auto``: on) lets a prompt adopt the
pages of a live prompt with the same prefix, copy-on-write, and
``--prefix-cache`` (default ``off``) keeps retired requests' pages in an
LRU trie for later prompts. ``--legacy`` also runs the old per-request
loop on the same prompts and prints the comparison. Weights are random,
drawn on the device from ``--seed``; prompts come from a numpy generator
seeded the same way. ``--smoke`` serves the reduced config. After a
paged drain (and the prefix cache's release) a hard leak gate fails the
run if any page is still in use.

``--sync-backend`` pins the admission planner's backend (``host``,
``cuda``, ``ref``; ``auto`` resolves from the machine abstraction and the
device) and ``--admission-sem`` the live gate's semaphore algorithm;
``--allocator-wait`` the page allocator's wait strategy.
``--fault-rate`` turns on chaos mode: one seeded ``FaultPlan``
(``--fault-seed``) aborts allocator batches, fails round dispatches and
stalls allocator holders at that rate, the allocator's watchdog armed;
every fault must be recovered, and the leak gate still applies.

``--open-loop`` drives the asyncio front-end instead: clients arrive as a
Poisson process at ``--arrival-rate`` req/s, stream their tokens, a
``--cancel-rate`` share hangs up mid-stream, ``--slo-ms`` is the
time-to-first-token SLO that splits goodput from throughput,
``--deadline-ms`` arms per-request deadlines in the engine, and
``--intake-limit`` bounds the ungranted population (past it a submit is
shed):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --smoke --device cpu --open-loop --requests 16 --capacity 4 \
        --arrival-rate 50 --cancel-rate 0.25 --slo-ms 500 \
        --kv-layout paged --fault-rate 0.1
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.abstraction import PrimitiveKind
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import (RequestState, ServeEngine,
                                      SlotServeEngine)
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.frontend import AsyncFrontend, IntakeFullError
from repro_torch.serve.kv_pages import PageLeakError
from repro_torch.serve.scheduler import plan_admission
from repro_torch.sync import SyncLibrary


def build(args, device):
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_encdec or cfg.frontend is not None:
        raise SystemExit("serve.py drives token-LM archs")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, model, model.init(gen, device)


def make_sync_library(args) -> SyncLibrary:
    """One SyncLibrary from the CLI knobs; injected everywhere."""
    return SyncLibrary.host_default(
        backend=None if args.sync_backend == "auto" else args.sync_backend,
        semaphore_kind=(None if args.admission_sem == "auto"
                        else args.admission_sem))


def make_fault_plan(args) -> Optional[FaultPlan]:
    """The chaos knob: one seeded FaultPlan driving every transient
    injection site (allocator abort, dispatch failure, stuck holder) at
    ``--fault-rate``, or None when chaos is off."""
    if getattr(args, "fault_rate", 0.0) <= 0.0:
        return None
    return FaultPlan(args.fault_seed, alloc_rate=args.fault_rate,
                     dispatch_rate=args.fault_rate,
                     stuck_rate=args.fault_rate, stuck_hold_s=5e-3)


def make_engine(model, params, args, device, sync=None,
                fault_plan: Optional[FaultPlan] = None) -> SlotServeEngine:
    """One engine from the CLI knobs, shared by both drive modes;
    ``fault_plan`` replaces the one ``--fault-rate`` would build."""
    if fault_plan is None:
        fault_plan = make_fault_plan(args)
    return SlotServeEngine(
        model, params, capacity=args.capacity,
        max_len=args.prompt_len + args.new_tokens + 1,
        decode_chunk=args.decode_chunk, kv_layout=args.kv_layout,
        page_size=args.page_size, num_pages=args.num_pages,
        page_growth=args.page_growth, allocator_wait=args.allocator_wait,
        prefix_sharing=args.prefix_sharing,
        prefix_cache=args.prefix_cache,
        cache_watermark=args.cache_watermark,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        round_token_budget=args.round_token_budget,
        attention_impl=args.attention_impl,
        bucketed_dispatch=args.bucketed_dispatch,
        fault_plan=fault_plan,
        allocator_watchdog_s=(1e-3 if fault_plan is not None else None),
        sync=sync if sync is not None else make_sync_library(args),
        device=device)


def enforce_leak_gate(engine) -> None:
    """Hard post-drain leak gate: a page still in use after a full drain
    fails the run with a non-zero exit (the slot layout has no pages).
    The prefix cache's pages are retained on purpose, so it is released
    first."""
    if engine.kv_layout != "paged":
        return
    engine.drop_prefix_cache()
    try:
        engine.pool.check()
    except (PageLeakError, AssertionError) as e:
        print(f"[serve] FATAL: post-drain page-leak check failed: {e}")
        raise SystemExit(1)
    leaked = int(engine.pool.pages.in_use)
    if leaked:
        print(f"[serve] FATAL: {leaked} of {engine.pool.pages.num_pages} "
              f"pages leaked after drain")
        raise SystemExit(1)
    print(f"[serve] post-drain leak check: OK "
          f"(0 of {engine.pool.pages.num_pages} pages leaked)")


def run_slot_engine(engine, prompts, new_tokens: int):
    """Closed loop: submit every request, drain. Returns wall seconds
    (ending in a device synchronise)."""
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, new_tokens)
    engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return time.perf_counter() - t0


def run_open_loop(model, params, prompts, args, device, sync=None,
                  fault_plan: Optional[FaultPlan] = None,
                  records: Optional[list] = None):
    """Open-loop traffic through the asyncio front-end: Poisson arrivals
    (``--arrival-rate``, seeded by ``--seed``), token streaming,
    mid-stream cancellations, deadlines and the TTFT SLO. Returns
    ``(engine, wall_s, report)``, the report carrying the open-loop
    ledger: TTFT percentiles, SLO attainment, goodput, shed, cancelled,
    expired and finished counts, rounds, and the pages still in use
    after the drain. ``records``, when given, receives each client's
    record: its index, streamed tokens, whether it was shed, and its
    ``StreamHandle``."""
    engine = make_engine(model, params, args, device, sync, fault_plan)
    rng = np.random.default_rng(args.seed)
    gaps_s = rng.exponential(1.0 / max(args.arrival_rate, 1e-9),
                             len(prompts))
    # which clients hang up, and after how many streamed tokens
    cancel_after = [
        (1 + int(rng.integers(0, max(args.new_tokens // 2, 1))))
        if rng.random() < args.cancel_rate else None
        for _ in prompts]
    deadline_s = (args.deadline_ms / 1e3
                  if args.deadline_ms is not None else None)
    results = records if records is not None else []

    async def client(fe, i, prompt):
        rec = {"i": i, "tokens": [], "shed": False, "handle": None}
        results.append(rec)
        try:
            h = await fe.submit(prompt, args.new_tokens,
                                deadline_s=deadline_s)
        except IntakeFullError:
            rec["shed"] = True
            return
        rec["handle"] = h
        async for tok in h:
            rec["tokens"].append(tok)
            if (cancel_after[i] is not None
                    and len(rec["tokens"]) >= cancel_after[i]):
                h.cancel()

    async def drive():
        async with AsyncFrontend(engine,
                                 intake_limit=args.intake_limit) as fe:
            tasks = []
            for i, prompt in enumerate(prompts):
                await asyncio.sleep(gaps_s[i])
                tasks.append(asyncio.ensure_future(client(fe, i, prompt)))
            await asyncio.gather(*tasks)
            await fe.drain()
            return fe.stats()

    t0 = time.perf_counter()
    fe_stats = asyncio.run(drive())
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall_s = time.perf_counter() - t0

    ttfts = sorted(r["handle"].ttft_s for r in results
                   if r["handle"] is not None
                   and r["handle"].ttft_s is not None)
    slo_s = args.slo_ms / 1e3
    good_tokens = sum(
        len(r["tokens"]) for r in results
        if r["handle"] is not None
        and r["handle"].state is RequestState.FINISHED
        and r["handle"].ttft_s is not None
        and r["handle"].ttft_s <= slo_s)
    leaked = 0
    if args.kv_layout == "paged":
        engine.pool.pages.check()      # raises PageLeakError on a leak
        leaked = engine.pool.pages.num_pages - engine.pool.pages.n_free
    report = {
        "wall_s": wall_s,
        "ttft_p50_ms": (1e3 * float(np.median(ttfts)) if ttfts
                        else float("nan")),
        "ttft_p99_ms": (1e3 * float(np.percentile(ttfts, 99)) if ttfts
                        else float("nan")),
        "slo_ms": args.slo_ms,
        "slo_attainment": (len([t for t in ttfts if t <= slo_s])
                           / max(len(ttfts), 1)),
        "goodput_tok_per_s": good_tokens / wall_s,
        "tok_per_s": fe_stats["tokens"] / wall_s,
        "shed": int(fe_stats["frontend_shed"]),
        "cancelled": int(fe_stats["cancelled"]),
        "expired": int(fe_stats["expired"]),
        "finished": int(fe_stats["finished"]),
        "rounds": int(fe_stats["frontend_rounds"]),
        "leaked_pages": int(leaked),
    }
    return engine, wall_s, report


def run_legacy_loop(model, params, prompts, args, device):
    """The old path: per-request prefill and a Python decode loop, one
    request after another. Returns (tokens, wall seconds, per-request
    start offsets in seconds)."""
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.new_tokens + 1)
    t0 = time.perf_counter()
    waits, tokens = [], 0
    for prompt in prompts:
        waits.append(time.perf_counter() - t0)
        out = engine.generate(
            {"tokens": torch.from_numpy(np.asarray(prompt))[None].to(device)},
            args.new_tokens)
        tokens += int(out.tokens.shape[0] * out.tokens.shape[1])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tokens, time.perf_counter() - t0, np.asarray(waits)


def make_prompts(args, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(args.seed)
    return rng.integers(0, vocab, size=(args.requests, args.prompt_len),
                        dtype=np.int32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an architecture of repro_torch.configs.ARCHS: "
                         "qwen3-14b, olmoe-1b-7b, phi3.5-moe-42b-a6.6b, "
                         "gemma3-1b, minitron-4b, qwen1.5-110b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=2)
    ap.add_argument("--kv-layout", default="slots",
                    choices=("slots", "paged"),
                    help="KV arena layout: contiguous [K, max_len] slots "
                         "or the block-table page arena")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-arena size (paged layout; default: "
                         "capacity * ceil(max_len / page_size))")
    ap.add_argument("--page-growth", default="lazy",
                    choices=("lazy", "eager"),
                    help="paged layout: grant pages per decode chunk "
                         "(admission gated by a headroom watermark) or "
                         "reserve the worst case at admission")
    ap.add_argument("--allocator-wait", default=None,
                    choices=("auto", "spin", "spin_backoff", "sleeping",
                             "adaptive"),
                    help="page-allocator mutex wait strategy; adaptive "
                         "re-selects between rounds from measured "
                         "contention (default: the library's choice)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="chunked prefill: prompt tokens each prefilling "
                         "slot advances per scheduler round, inside the "
                         "decode dispatch (default: one-shot prefill at "
                         "admission)")
    ap.add_argument("--prefix-sharing", default="auto",
                    choices=("auto", "on", "off"),
                    help="copy-on-write prompt-prefix sharing on the paged "
                         "arena (auto = on for the paged layout)")
    ap.add_argument("--prefix-cache", default="off",
                    choices=("auto", "on", "off"),
                    help="retain retired requests' full pages in an LRU "
                         "prefix trie for later prompts (paged; auto = on "
                         "for the paged layout)")
    ap.add_argument("--cache-watermark", type=float, default=None,
                    help="free-page share the prefix cache's eviction "
                         "defends (default: the admission headroom)")
    ap.add_argument("--round-token-budget", type=int, default=None,
                    help="per-round token budget: decode rows first, then "
                         "prefill chunks (default: every slot funded)")
    ap.add_argument("--attention-impl", default="gather",
                    choices=("gather", "fused"),
                    help="paged decode read path: gather-then-attend or "
                         "the fused paged-decode kernel")
    ap.add_argument("--bucketed-dispatch", default="auto",
                    choices=("auto", "on", "off"),
                    help="gather the active slots into power-of-2 "
                         "occupancy buckets per round")
    ap.add_argument("--open-loop", action="store_true",
                    help="drive the asyncio front-end instead of the "
                         "closed loop: Poisson arrivals, token streaming, "
                         "mid-stream cancellation, TTFT SLO")
    ap.add_argument("--arrival-rate", type=float, default=16.0,
                    help="open loop: mean client arrival rate, requests/s "
                         "(exponential inter-arrival gaps)")
    ap.add_argument("--cancel-rate", type=float, default=0.0,
                    help="open loop: share of clients that cancel after a "
                         "random number of streamed tokens")
    ap.add_argument("--slo-ms", type=float, default=1000.0,
                    help="open loop: time-to-first-token SLO; goodput "
                         "counts only finished requests that met it")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="open loop: per-request deadline armed in the "
                         "engine (queued past it: expired; active past it: "
                         "late) (default: none)")
    ap.add_argument("--intake-limit", type=int, default=256,
                    help="open loop: bound on the ungranted population "
                         "(intake + engine queue); submits past it are "
                         "shed")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos mode: per-consult probability of each "
                         "injected fault (allocator batch abort, dispatch "
                         "failure, stuck allocator holder); 0 = off")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultPlan seed: same seed and workload inject "
                         "the same faults at the same points")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--legacy", action="store_true",
                    help="also run the old per-request loop")
    ap.add_argument("--sync-backend", default="auto",
                    choices=("auto", "host", "cuda", "ref"),
                    help="admission-planner backend (auto: from the "
                         "machine abstraction and the device)")
    ap.add_argument("--admission-sem", default="auto",
                    choices=("auto", "sleeping", "spin", "spin_backoff"),
                    help="live admission-gate semaphore algorithm (auto: "
                         "the library's selection)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> SlotServeEngine:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, params = build(args, device)
    sync = make_sync_library(args)
    choice = sync.choice(PrimitiveKind.SEMAPHORE,
                         semaphore_initial=args.capacity)
    gate = (choice.algorithm if args.admission_sem == "auto"
            else args.admission_sem)
    print(f"[serve] {cfg.name} on {device}: gate={gate} (selected "
          f"{choice.algorithm}/{choice.strategy.value}) planner="
          f"{sync.planning_backend_name(device)} "
          f"machine={sync.machine.name}({sync.machine_class()})")
    plan = plan_admission(np.zeros(args.requests, np.float32),
                          np.full(args.requests, float(args.new_tokens),
                                  np.float32),
                          args.capacity, lib=sync, device=device)
    print(f"[serve] plan[{plan.backend}]: p50 wait {plan.p50_wait:.1f} "
          f"steps p99 {plan.p99_wait:.1f} makespan {plan.makespan:.1f} "
          f"queued {int(plan.waited.sum())}/{args.requests}")
    prompts = make_prompts(args, cfg.vocab_size)
    report = None
    if args.open_loop:
        engine, dt, report = run_open_loop(model, params, prompts, args,
                                           device, sync)
    else:
        engine = make_engine(model, params, args, device, sync)
        dt = run_slot_engine(engine, prompts, args.new_tokens)
    st = engine.stats()
    print(f"[serve] {args.kv_layout} engine: {int(st['finished'])} "
          f"requests, {int(st['tokens'])} tokens in {dt:.2f}s "
          f"({st['tokens'] / dt:,.1f} tok/s), "
          f"{int(st['decode_dispatches'])} dispatches, p50 wait "
          f"{st['p50_wait_steps']:.0f} steps p99 {st['p99_wait_steps']:.0f}")
    if engine.prefill_chunk:
        print(f"[serve] chunked prefill: {engine.prefill_chunk} tok/chunk, "
              f"{int(st['prefill_chunks'])} chunks over "
              f"{int(st['prefill_tokens'])} prompt tokens")
    else:
        print(f"[serve] one-shot prefill: {int(st['prefill_tokens'])} "
              f"prompt tokens, pad fraction {st['pad_fraction']:.3f}, "
              f"{int(st['decode_rounds_stalled_by_prefill'])} decode "
              f"rounds stalled by prefill")
    if engine.kv_layout == "paged":
        print(f"[serve] paged attention: impl={engine.attention_impl}, "
              f"bucketed dispatch "
              f"{'on' if engine.bucketed_dispatch else 'off'} "
              f"({int(st['dispatch_shapes'])} shapes)")
        print(f"[serve] allocator lock ({engine.page_growth} growth): "
              f"{int(st['lock_acquires'])} acquires "
              f"({int(st['lock_contended_acquires'])} contended), "
              f"{st['lock_acquires_per_token']:.4f} per token vs "
              f"{st['per_page_lock_acquires_per_token']:.4f} one-per-page; "
              f"{int(st['page_pauses'])} pauses, "
              f"{int(st['page_preemptions'])} preemptions")
        share = "on" if engine.prefix_sharing else "off"
        print(f"[serve] prefix sharing {share}: "
              f"{int(st['prefix_hits'])} hits, "
              f"{int(st['shared_pages_adopted'])} pages adopted, "
              f"{int(st['cow_splits'])} CoW splits, "
              f"{st['pages_per_token']:.3f} pages alloc'd per token")
        if engine.prefix_cache is not None:
            print(f"[serve] prefix cache: "
                  f"{int(st['cache_hits'])} hits "
                  f"(rate {st['cache_hit_rate']:.2f}), "
                  f"{int(st['cache_tokens_served'])} tokens served, "
                  f"{int(st['prefill_tokens_saved'])} prefill tokens "
                  f"saved; {int(st['cache_pages_held'])} pages held / "
                  f"{int(st['cache_pages_donated'])} donated / "
                  f"{int(st['cache_pages_evicted'])} evicted")
    if engine.fault_plan is not None:
        fp = engine.fault_plan
        print(f"[serve] chaos (seed {fp.seed}, rate {args.fault_rate}): "
              f"{int(st['faults_injected'])} faults injected "
              f"{dict(fp.by_kind)}, "
              f"{int(st['rounds_retried'])} rounds retried, "
              f"{int(st['requests_quarantined'])} quarantined, "
              f"{int(st['failed'])} failed, "
              f"{int(st.get('watchdog_trips', 0))} watchdog trips")
    fifo_ok = engine.grant_log == sorted(engine.grant_log)
    print(f"[serve] FIFO grant order: {'OK' if fifo_ok else 'VIOLATED'} "
          f"({len(engine.grant_log)} grants; semaphore admitted "
          f"{engine.admission.admitted}, completed "
          f"{engine.admission.completed})")
    if report is not None:
        print(f"[serve] open loop: {report['finished']} finished / "
              f"{report['cancelled']} cancelled / "
              f"{report['expired']} expired / {report['shed']} shed "
              f"over {report['rounds']} rounds in {report['wall_s']:.2f}s")
        print(f"[serve] open loop: TTFT p50 {report['ttft_p50_ms']:.0f}ms "
              f"p99 {report['ttft_p99_ms']:.0f}ms, SLO {args.slo_ms:.0f}ms "
              f"met by {report['slo_attainment']:.0%}, goodput "
              f"{report['goodput_tok_per_s']:,.1f} tok/s of "
              f"{report['tok_per_s']:,.1f} total; time-in-state p99 "
              f"(steps): queued {st['p99_queued_steps']:.0f} / prefill "
              f"{st['p99_prefill_steps']:.0f} / decode "
              f"{st['p99_decode_steps']:.0f}")
        if args.kv_layout == "paged":
            print(f"[serve] open loop: leaked pages after drain: "
                  f"{report['leaked_pages']} (free-list "
                  f"{engine.pool.pages.n_free}/"
                  f"{engine.pool.pages.num_pages})")
    enforce_leak_gate(engine)
    if not fifo_ok:
        raise SystemExit(1)
    if args.legacy:
        tokens, dt_old, waits = run_legacy_loop(model, params, prompts, args,
                                                device)
        print(f"[serve] legacy loop: {tokens} tokens in {dt_old:.2f}s "
              f"({tokens / dt_old:,.1f} tok/s), p50 wait "
              f"{np.median(waits):.2f}s p99 {np.percentile(waits, 99):.2f}s")
        print(f"[serve] slot-engine speedup: {dt_old / dt:.2f}x")
    return engine


if __name__ == "__main__":
    main()
