"""Serving entry point: closed-loop continuous batching behind the
Algorithm-5 semaphore (counterpart of ``repro.launch.serve``; the open
loop, legacy loop and chaos mode are not ported yet).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --requests 8 --capacity 4 --prompt-len 128 --new-tokens 16

One engine replica on the card (``--device cuda``, the default; ``--device
cpu`` runs the kernels' plain versions): a paged KV arena whose page
allocator runs under the Algorithm-3 ticket mutex, the Algorithm-5
semaphore kernel replanning admission every scheduler round, chunked
prefill inside the decode dispatch, and the fused paged-decode kernel.
Weights are random, drawn on the device from ``--seed``; prompts come
from a numpy generator seeded the same way. ``--smoke`` serves the
reduced config. After the drain a hard leak gate fails the run if any
page is still in use.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.abstraction import PrimitiveKind
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import SlotServeEngine
from repro_torch.serve.kv_pages import PageLeakError
from repro_torch.serve.scheduler import plan_admission
from repro_torch.sync import SyncLibrary


def build(args, device):
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, model, model.init(gen, device)


def make_engine(model, params, args, device, sync=None) -> SlotServeEngine:
    return SlotServeEngine(
        model, params, capacity=args.capacity,
        max_len=args.prompt_len + args.new_tokens + 1,
        decode_chunk=args.decode_chunk, page_size=args.page_size,
        num_pages=args.num_pages,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        round_token_budget=args.round_token_budget,
        attention_impl=args.attention_impl,
        bucketed_dispatch=args.bucketed_dispatch,
        sync=sync if sync is not None else SyncLibrary.host_default(),
        device=device)


def enforce_leak_gate(engine) -> None:
    """Hard post-drain leak gate: a page still in use after a full drain
    fails the run with a non-zero exit."""
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


def make_prompts(args, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(args.seed)
    return rng.integers(0, vocab, size=(args.requests, args.prompt_len),
                        dtype=np.int32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-arena size (default: capacity * "
                         "ceil(max_len / page_size))")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=16,
                    help="prompt tokens each prefilling slot advances per "
                         "scheduler round, inside the decode dispatch")
    ap.add_argument("--round-token-budget", type=int, default=None,
                    help="per-round token budget: decode rows first, then "
                         "prefill chunks (default: every slot funded)")
    ap.add_argument("--attention-impl", default="fused",
                    choices=("gather", "fused"),
                    help="paged decode read path: the fused paged-decode "
                         "kernel or gather-then-attend")
    ap.add_argument("--bucketed-dispatch", default="auto",
                    choices=("auto", "on", "off"),
                    help="gather the active slots into power-of-2 "
                         "occupancy buckets per round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> SlotServeEngine:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, params = build(args, device)
    sync = SyncLibrary.host_default()
    choice = sync.choice(PrimitiveKind.SEMAPHORE,
                         semaphore_initial=args.capacity)
    print(f"[serve] {cfg.name} on {device}: gate={choice.algorithm}/"
          f"{choice.strategy.value} planner="
          f"{sync.planning_backend_name(device)} "
          f"machine={sync.machine.name}({sync.machine_class()})")
    plan = plan_admission(np.zeros(args.requests, np.float32),
                          np.full(args.requests, float(args.new_tokens),
                                  np.float32),
                          args.capacity, lib=sync, device=device)
    print(f"[serve] plan[{plan.backend}]: p50 wait {plan.p50_wait:.1f} "
          f"steps p99 {plan.p99_wait:.1f} makespan {plan.makespan:.1f} "
          f"queued {int(plan.waited.sum())}/{args.requests}")
    engine = make_engine(model, params, args, device, sync)
    dt = run_slot_engine(engine, make_prompts(args, cfg.vocab_size),
                         args.new_tokens)
    st = engine.stats()
    print(f"[serve] paged engine: {int(st['finished'])} requests, "
          f"{int(st['tokens'])} tokens in {dt:.2f}s "
          f"({st['tokens'] / dt:,.1f} tok/s), "
          f"{int(st['decode_dispatches'])} dispatches, p50 wait "
          f"{st['p50_wait_steps']:.0f} steps p99 {st['p99_wait_steps']:.0f}")
    print(f"[serve] chunked prefill: {engine.prefill_chunk} tok/chunk, "
          f"{int(st['prefill_chunks'])} chunks over "
          f"{int(st['prefill_tokens'])} prompt tokens; attention "
          f"{engine.attention_impl}, bucketed dispatch "
          f"{'on' if engine.bucketed_dispatch else 'off'} "
          f"({int(st['dispatch_shapes'])} shapes)")
    print(f"[serve] allocator lock: {int(st['lock_acquires'])} acquires "
          f"({int(st['lock_contended_acquires'])} contended), "
          f"{st['lock_acquires_per_token']:.4f} per token vs "
          f"{st['per_page_lock_acquires_per_token']:.4f} one-per-page; "
          f"{int(st['page_pauses'])} pauses, "
          f"{int(st['page_preemptions'])} preemptions")
    fifo_ok = engine.grant_log == sorted(engine.grant_log)
    print(f"[serve] FIFO grant order: {'OK' if fifo_ok else 'VIOLATED'} "
          f"({len(engine.grant_log)} grants; semaphore admitted "
          f"{engine.admission.admitted}, completed "
          f"{engine.admission.completed})")
    enforce_leak_gate(engine)
    if not fifo_ok:
        raise SystemExit(1)
    return engine


if __name__ == "__main__":
    main()
