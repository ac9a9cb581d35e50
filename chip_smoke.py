#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card: serving, the
encoder-decoder and stub-frontend families, training, the sync
library's plans with the paper's kernel benchmarks, and the paper's
simulators and table benchmarks.

    python3 chip_smoke.py            # phases 1-4 and 6-15, one card

Run from the root of a checkout; it needs ``src/repro_torch`` beside it
and a CUDA card, and exits non-zero without printing a result otherwise.
It never imports ``jax`` or the JAX package. Phases, each printing one
JSON line with its seconds:

  1 card     the card's name and power limit (nvidia-smi); all five
             CUDA kernels built from ``src/repro_torch/csrc`` in
             parallel, one nvcc each
  2 kernels  each kernel against its plain torch version on the card,
             with its time, the plain version's time, the bound and the
             library yardstick (paged decode also on negative table
             entries, against its split model, on a long-context row of
             4 x 4096 positions, and two launches bit-equal; the
             admission kernel bit-identical over N x K grids of random
             and tie-heavy traces, and past its register layout at K
             1025 and 2048; the ticket lock at N 1 to 4096 on seeded
             permutations, and past its staging at N 16385 and 32768;
             the barrier over seeded epochs at N 1 to 32768, and with
             global flags at 32769 and 65536, with poll budgets 0, 1
             and 1024; every membench cell at 132 and 1056 steps; the
             past-limit kernels timed beside the fast path at the old
             limit; paged decode at head dim 256 in the f32 grid, and
             at gemma3-1b's shape — one kv head, G 4, window 512, a row
             past the window — in bf16 and f32, with and without the
             window, on phase 10's table and on a 4 x 4096 row; and at
             jamba-1.5-large's shape — 8 kv heads, G 8, hd 128 — in
             bf16 on phase 12's table); the lock, the
             admission kernel and the barrier also print their whole
             planning call, the launch floor and a latency estimate
             beside the byte bound
  3 parity   reduced qwen3-14b served on cuda (kernels) and on cpu
             (plain versions) from the same weights and requests — the
             main path, the slot arena one-shot and chunked, the paged
             arena one-shot with eager growth, and the legacy engine on
             two requests: greedy streams and grant logs identical; then
             four prefix runs (sharing over a repeated prompt and a
             boundary prefix, a donor-side split in a partial page, the
             cache over a two-turn conversation, watermark eviction):
             streams, grant logs, acquires and the sharing and cache
             counts identical; then three lifecycle runs (cancels in
             every state with step deadlines, chaos, a poisoned rid):
             streams, states, grant logs, acquires, the lifecycle counts
             and the faults by kind identical; then the reduced
             configs of phase 10's five families, and gemma3-1b with
             two leftover layers, on the main path: streams, grant logs
             and acquires identical; then reduced falcon-mamba-7b,
             jamba-1.5-large-398b (8 layers) and jamba at 4 layers on
             the phase-4 engine's arguments and on the slot arena:
             streams, grant logs, acquires and the resolved gates (the
             reference's: eager, no chunking, no bucketing, no sharing)
             identical, and the legacy engine on two requests; then
             reduced qwen3-14b sampled (T 0.8, seed 0) twice on cuda
             (streams identical) and under dispatch faults (streams
             equal to the fault-free run, rounds retried); then reduced
             whisper-small through the legacy engine (streams
             identical) and reduced internvl2-76b's prefill and decode
             on embeddings (argmaxes identical); then three reduced
             gemma3-1b train steps (params within 1e-4) and a bf16
             checkpoint of the result restored bit-equal
  4 serve    full-width qwen3-14b (40 layers, bf16) serving 8 requests
             through the paged, chunked-prefill, bucketed engine (prefix
             sharing on, as the reference resolves it; random prompts
             share nothing); launch counters prove both kernels carried
             the path
  5 profile  (only when named: ``--phases 1,5``) six decode rounds of
             the phase-4 workload timed plainly, then six more under
             torch.profiler: device time by kernel and the device's
             idle share (busy over the unprofiled wall time);
             ``--profile-layout slots`` profiles phase 7's slot-arena
             engine instead
  6 primitives  the sync library's plan path on the card: a GPU machine
             abstraction resolves to the ``cuda`` backend; plan_mutex,
             plan_mutex_bounded and plan_barrier agree with the ``ref``
             and ``host`` backends; the batched page ledger, the kernel
             benchmark records (every ``match`` true), the membench cells
             timed at the paper's size, and the plan latencies; launch
             counters prove the lock, barrier and membench kernels
             carried the path
  7 slots    the reference's default serving path at full width, with
             phase 4's weights: the slot arena, one-shot prefill, decode
             chunk 2, phase 4's 8 requests; then the legacy loop on the
             first 2; launch counters prove the admission kernel carried
             the slots path
  8 prefix   full width with phase 4's weights: 8 requests sharing a
             128-token preamble, two of them one prompt exactly, staggered
             arrivals — on the phase-4 engine with sharing on and off, on
             its one-shot variant (the exact repeat adopts the partial
             tail page and splits it), and with the prefix cache on over
             two turns (turn 2 resubmits prompt + reply + 16 tokens);
             adoptions, splits, cache hits and skipped prefill tokens,
             no leak after the drain, launch counters over the phase
  9 lifecycle  full width with phase 4's weights on the phase-4 engine:
             phase 4's traffic with cancels in QUEUED, PREFILLING and
             DECODING and step deadlines (one expiring in the queue, one
             passed while decoding); under seeded chaos (allocator
             aborts, dispatch failures, stuck holders past the watchdog);
             with dispatch faults only (streams equal to the fault-free
             run); with a poisoned request (quarantined alone); then the
             launcher's open loop (16 Poisson clients, cancels, a TTFT
             SLO, deadlines, a bounded intake, executor deaths): every
             client accounted for, each stream equal to its request's
             tokens; launch counters over the phase, and per run
 10 families  the other attention-only decoders at full width, bf16,
             random weights from seed 0, one at a time after phase 4's
             weights are freed, through the phase-4 engine: olmoe-1b-7b
             (MoE, 16 layers) on phase 4's traffic; gemma3-1b (26 layers,
             hd 256, window 512 on its local layers) on the same with two
             prompts of 640 and 1000 tokens; minitron-4b (32 layers),
             and phi3.5-moe-42b-a6.6b and qwen1.5-110b cut to 4 layers
             (whole, they outgrow the card), on 4 requests each:
             tokens/s, acquires per token, every request finished, no
             page leaked, the decode kernel in every layer of every
             decode step and the admission kernel
 11 servebench  the serving benchmark's twin
             (``repro_torch.benchmarks.servebench``): (a) at the
             reference CI's command line on reduced qwen3-14b, float32,
             TF32 off, on cuda and on cpu from the same weights — every
             gate of counts and streams (``ci_gates``) passes on cuda,
             every number no clock measured is identical, the
             watchdog's trips equal the stuck holders on both, and the
             one wall-clock gate is reported; (b) at full width (weights
             from seed 0), 16 requests, prompt 128, capacity 4, page 16,
             decode chunk 4, through the benchmark's row functions:
             legacy on 2 requests, paged lazy and eager (the reference's
             defaults: gather, one-shot), gather once and the fused row
             (chunked, bucketed: the main path, the only row through the
             decode kernel) three times, interleaved chunked, the open
             loop three times: medians and spreads of the fused row's
             tokens/s and waits and of TTFT, every request finished,
             FIFO grants, no page leaked; launch counters over (b); the
             host's state (live objects, eager launch and Python loop
             times) before and after; (c) the host benchmark on the
             card's host, beside its CPU model
 12 ssm      the recurrent decoders at full width, bf16, random weights
             from seed 0, one at a time after earlier weights are freed,
             through the phase-4 engine's arguments (bucketed dispatch
             ``auto``: ``on`` raises for a mamba layer): falcon-mamba-7b
             (64 layers, not cut) on phase 4's 8 requests, then 4
             requests sampled at T 0.8 twice on its weights (streams
             identical) and 1e5 draws of the engine's sampler against the
             softmax of one 65024-wide row; jamba-1.5-large-398b cut to
             4 layers (attention + 3 mamba) on 4 requests: the gates the
             reference resolves, every request finished, FIFO grants, no
             page leaked, the decode kernel once per attention layer of
             each decode step (never for falcon-mamba), the admission
             kernel once per round with a queue; tokens/s, prefill ms
             per token, ms per decode round, peak memory
 13 encdec   the encoder-decoder and stub-frontend families at full
             width, bf16, random weights from seed 0: whisper-small
             (0.24 B parameters) through the legacy engine on 4
             requests of 1500 frames, 64 new tokens; internvl2-76b cut
             to 8 of its 80 layers (7.9 B) on 2 x 1024 embeddings and
             16 decode steps on embeddings: tokens/s, prefill ms, peak
             memory, finite logits, prefill + decode against the
             teacher-forced decoder / the forward at the last position
             within the reference's 2e-2; no kernel launches
 14 train    the port's launch/train.py on gemma3-1b at full width and
             depth (26 layers, vocab 262144, window 512 at seq 1024),
             batch 4: 6 steps with a checkpoint after step 3, a crash
             (the end's checkpoint dropped), --resume: the resumed params
             and moments equal the crashed run's within atol 1e-5 /
             rtol 1e-4, losses finite and falling; ms a step, tokens/s,
             peak memory; no kernel launches
 15 paper    the paper's simulators and table benchmarks on the card's
             machine: membench's Tables 1-3 (simulated) and the host
             row (measured), Table 5 (8/8), the Section-7 headlines
             (equal to the JAX package's strings), Figures 1-3 at
             blocks (1, 30) Tesla and (1, 32) Fermi (no violation, FA
             rows fair), the plan latencies on host, cuda and ref, the
             alloc sweep at the reference's defaults, the
             sync_primitives twin on cuda (every backend == ref, the
             admission plan on cuda) and the quickstart's 10 training
             steps (the first batch's loss falls); launch counters prove
             the semaphore, lock and barrier kernels carried the phase
Then the run's total seconds, one JSON line naming every kernel with its
launches (from phase 4 for the serving kernels, from phase 6 for the
others; each path's, phases 8-15 among them, in ``launches_by_path``),
times and bound, and last the device line. Every failed check exits non-zero before the
last line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W).
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# Full-width main-path settings (phase 4); the kernel checks of phase 2
# use the shapes these settings give the kernels.
SERVE = dict(capacity=4, requests=8, prompt_min=64, prompt_max=256,
             new_tokens=16, page_size=16, prefill_chunk=64, decode_chunk=1)
REDUCED = dict(capacity=3, requests=6, prompt_min=5, prompt_max=24,
               new_tokens=8, page_size=4, prefill_chunk=4, decode_chunk=2)
# Phase 8's traffic: a shared system prompt (numpy seed 3), requests
# arriving every ``gap`` scheduler rounds, two of them one prompt
# exactly (``repeat``: the second repeats the first), and a second turn
# of ``follow`` new user tokens.
PREFIX = dict(requests=8, preamble=128, suffix_min=16, suffix_max=64,
              new_tokens=16, follow=16, gap=3, repeat=(4, 5))
# Phase 10's models (arch, layers kept or None for full depth, requests)
# on phase 4's settings; gemma3-1b also serves two prompts past its
# local layers' window (FAMILY_LONG_PROMPTS, numpy seed 5). phi3.5-moe
# (84 GB in bf16) and qwen1.5-110b (222 GB) keep 4 of their layers to fit
# the card's 80 GB.
FAMILIES = (("olmoe-1b-7b", None, 8), ("gemma3-1b", None, 8),
            ("minitron-4b", None, 4), ("phi3.5-moe-42b-a6.6b", 4, 4),
            ("qwen1.5-110b", 4, 4))
FAMILY_LONG_PROMPTS = (640, 1000)
# The paper's Section-3 cell size: 8 CTAs per SM of 132, 1000 accesses.
MEMBENCH_CELL = dict(n_steps=1056, repeats=1000)

# Cycles one step of each sequential kernel waits on, for the
# dependent-chain estimates printed beside the byte bounds (assumed
# latencies: 4 cycles per ALU op, ~20 per warp collective, ~30 per
# shared-memory access): the admission kernel's redux minimum, the tied
# lane's ballot and find-first, its insert and new key, per arrival; the
# lock's turn store and the next holder's load, its chain load,
# multiply, add and store, per requester.
SEMAPHORE_STEP_CYCLES = 64
LOCK_STEP_CYCLES = 130
# The barrier's latency estimate (same assumed latencies, ~600 cycles for
# a global load): its fixed part, and each check of a 128-word chunk by
# the master (two shared loads deep, a vote, the loop), in each of its
# two scans.
BARRIER_CYCLES = 1200
BARRIER_CHUNK_CYCLES = 120

# every kernel of the paged-decode op and of membench (the profiler
# filters read them)
DECODE_KERNELS = ("paged_decode_kernel",)
MEMBENCH_KERNELS = ("membench_kernel", "membench_serial_kernel")

# Phase 15: the Section-7 headline strings the JAX package prints (its
# benchmarks/primitives.py::headline_speedups; simulated, so every
# machine prints them), and the sweep's block lists, cut from the
# --fast lists (1, 30, 120, 240) / (1, 32, 128) for the phase's time.
PAPER_HEADLINES = ("x=12.1;paper=40", "pct=223;paper=40",
                   "x=116.8;paper=70", "x=234.7;paper=3")
PAPER_SWEEP = {"tesla": (1, 30), "fermi": (1, 32)}

SOURCES = ["paged_decode.cu", "semaphore_admission.cu", "ticket_lock.cu",
           "xf_barrier.cu", "membench.cu"]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def attention_layers(cfg) -> int:
    """Layers that launch the decode kernel each decode step (every layer
    but a mamba one)."""
    return sum(kind != "mamba" for kind in cfg.layer_kinds())


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ timing
def cuda_ms(fn, reps: int = 50, flush_mb: int = 64) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    with the 50 MB L2 overwritten before each one (the decode path finds
    its arena cold: a layer's weights pass through L2 between reads)."""
    import torch
    flush = torch.empty(flush_mb << 18, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(fn, name, reps: int = 20):
    """Mean device time in ms per call of ``fn`` of the kernels whose
    name holds ``name`` (a string, or a tuple naming every kernel of the
    op), over ``reps`` calls, from torch.profiler (CUPTI): the kernels
    alone. An event pair around a call also counts the wrapper's small
    fills and the host's gaps between its ops, which for these
    latency-bound kernels can be most of the time. ``None`` when two
    traces in a row show no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    for _ in range(2):     # a trace that caught no kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.key_averages():
            if not any(n in evt.key for n in names) or "CUDA" not in str(
                    getattr(evt, "device_type", "")):
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            total_us += dev_us
        if total_us:
            return total_us / reps / 1e3
    return None


def host_ms(fn, reps: int = 20, sync=None) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` calls after a warm
    one, each closed by ``sync`` (a CUDA synchronise by default)."""
    import torch
    sync = sync or torch.cuda.synchronize
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(text):
    """``{"<dtype> hd<HD> gm<GM>": [registers, spill bytes, smem bytes]}``
    for each instantiation of the decode kernel, from ``-Xptxas -v``."""
    import re
    rows, name, spill = {}, None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"paged_decode_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                          m.group(1))
            name = (f"{'bf16' if 'bfloat16' in t.group(1) else 'f32'} "
                    f"hd{t.group(2)} gm{t.group(3)}") if t else None
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name:
            rows[name] = [int(m.group(1)), spill, int(m.group(2) or 0)]
    return rows


def ptxas_kernels(text):
    """``{"<kernel><template args>": [registers, spill bytes, smem
    bytes]}`` for every entry function of a source, from ``-Xptxas
    -v``."""
    import re
    rows, name, spill = {}, None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            base = re.search(r"\d+([a-z]\w*?_kernel)", m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = (base.group(1) if base else m.group(1)) + (
                f"<{','.join(args)}>" if args else "")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name:
            rows[name] = [int(m.group(1)), spill, int(m.group(2) or 0)]
    return rows


# ------------------------------------------------------------ phase 1: card
def phase_card(out):
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    check(bool(card), f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        max_mhz, now_mhz = (float(x) for x in
                            clk.stdout.splitlines()[0].split(","))
    except (IndexError, ValueError):
        max_mhz = now_mhz = None
    t0 = time.perf_counter()
    libs = build.build(SOURCES)
    ptxas = {}
    for src, lib in libs.items():
        log = lib.with_name(lib.name + ".log")
        text = log.read_text() if log.is_file() else ""
        ptxas[src] = (ptxas_summary(text) if src == "paged_decode.cu"
                      else ptxas_kernels(text))
    out["card"] = card
    out["sm_clock_mhz"] = max_mhz
    import torch
    import torch.distributed as dist
    nccl = dist.is_available() and dist.is_nccl_available()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'available' if nccl else 'NOT available: phase 16 fails'}",
          flush=True)
    return {"card": card, "torch": torch.__version__, "nccl": nccl,
            "sm_clock_max_mhz": max_mhz,
            "sm_clock_now_mhz": now_mhz, "nvcc": build.nvcc(),
            "build_s": time.perf_counter() - t0, "ptxas": ptxas}


# --------------------------------------------------------- phase 2: kernels
def decode_case(seed, *, b, kv, g, hd, ps, num_pages, p_cap, dtype,
                max_len=None, dead_row=False):
    """Random paged-decode inputs on the card: ragged lengths (a
    zero-length row when b > 2), allocated prefixes with sentinel tails,
    optionally one fully-sentinel row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = "cuda"
    q = torch.tensor(rng.standard_normal((b, kv, g, hd)), dtype=dtype,
                     device=dev)
    k = torch.tensor(rng.standard_normal((num_pages, ps, kv, hd)),
                     dtype=dtype, device=dev)
    v = torch.tensor(rng.standard_normal((num_pages, ps, kv, hd)),
                     dtype=dtype, device=dev)
    hi = max_len if max_len is not None else p_cap * ps
    lens = rng.integers(1, hi + 1, size=b)
    if b > 2:
        lens[1] = 0
    pages = np.full((b, p_cap), num_pages, np.int32)
    for i in range(b):
        need = -(-int(lens[i]) // ps)
        if need:
            pages[i, :need] = rng.choice(num_pages, size=need, replace=False)
    if dead_row:
        pages[-1] = num_pages
    return (q, k, v, torch.tensor(pages, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def decode_work(q, k, pages, lens, window=None):
    """(bytes, ops) the function must move and do on these inputs: live
    K/V positions read once, q read once, output written once; two
    length-hd products (QK and PV) per (query head, live position)."""
    import torch
    b, kv, g, hd = q.shape
    num_pages, ps = k.shape[0], k.shape[1]
    pos = torch.arange(pages.shape[1] * ps, device=q.device)
    cl = lens.long()[:, None]
    live = (pos[None] < cl) & (pages < num_pages).repeat_interleave(ps, 1)
    if window is not None:
        live &= pos[None] >= cl - window
    n_live = int(live.sum())
    el = q.element_size()
    nbytes = (2 * n_live * kv * hd * el + 2 * q.numel() * el
              + pages.numel() * 4 + lens.numel() * 4)
    ops = 4.0 * n_live * kv * g * hd
    return nbytes, ops


def within_bf16(got, want, tol):
    """Both accumulate in fp32; the last rounding to bf16 may fall either
    side of a tie, so one bf16 ulp of the value rides on ``tol``."""
    got, want = got.float(), want.float()
    excess = (got - want).abs() - tol - want.abs() * 2.0 ** -7
    return float(excess.max()) <= 0.0, float((got - want).abs().max())


def sdpa_ms(q, k, v, pages, lens, window=None):
    """Library yardstick, never called by the port: SDPA over the
    gathered, head-expanded view with the length mask (and the window's,
    when given; the gather is not timed)."""
    import torch
    import torch.nn.functional as F
    b, kvh, g, hd = q.shape
    idx = pages.long().clamp(0, k.shape[0] - 1)
    kb = k[idx].reshape(b, -1, kvh, hd)
    vb = v[idx].reshape(b, -1, kvh, hd)
    ke = kb.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    ve = vb.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    qh = q.reshape(b, kvh * g, 1, hd)
    pos = torch.arange(ke.shape[2], device="cuda")[None]
    mask = pos < lens.long()[:, None]
    if window is not None:
        mask &= pos >= lens.long()[:, None] - window
    mask = mask[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, ke, ve, attn_mask=mask))


def decode_plan(q, pages):
    """(splits, pages_per_split, CTAs per SM) the wrapper plans."""
    from repro_torch.kernels import paged_attention as pa
    ctas = pa.ctas_per_sm(q.shape[3], q.dtype)
    return (*pa.plan_splits(pages.shape[1], q.shape[0], q.shape[1],
                            pa.sm_count(q.device), ctas), ctas)


def time_decode(q, k, v, pages, lens, window=None):
    """Call, kernel, plain and SDPA times and the bound at one shape (the
    bound counts only live positions: inside the length, the window and
    allocated pages)."""
    from repro_torch.kernels import paged_attention as pa
    nbytes, ops = decode_work(q, k, pages, lens, window)
    bms, bby = bound_ms(nbytes, ops, "bfloat16")
    splits, pps, ctas = decode_plan(q, pages)
    return {"ms": cuda_ms(lambda: pa.paged_decode(q, k, v, pages, lens,
                                                  window=window)),
            "kernel_ms": kernel_ms(lambda: pa.paged_decode(
                q, k, v, pages, lens, window=window), DECODE_KERNELS),
            "plain_ms": cuda_ms(lambda: pa.paged_decode_plain(
                q, k, v, pages, lens, window=window)),
            "library_ms": sdpa_ms(q, k, v, pages, lens, window),
            "bound_ms": bms, "bound_by": bby, "bytes": nbytes, "ops": ops,
            "splits": splits, "pages_per_split": pps, "ctas_per_sm": ctas}


def check_paged_decode():
    """The decode kernel against its plain version: the reference's grid
    in f32 (page sizes, GQA shapes, windows, dead and empty rows) at hd
    32, 128 and 256; a table with negative entries and sentinels; the
    kernel's split model; the main path's shape in f32 and bf16; the
    long-context row in bf16; two launches bit-equal at both timed
    shapes; then gemma3-1b's hd-256 shapes (``check_decode_hd256``)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    tol_f32, tol_bf16 = 1e-5, 2e-3
    worst = 0.0
    n_cases = 0
    for hd in (32, 128, 256):
        for ps in (1, 4, 16):
            for kv, g in ((8, 1), (2, 4), (1, 8), (8, 5)):
                for window in (None, 5):
                    q, k, v, pages, lens = decode_case(
                        ps * 10 + kv, b=4, kv=kv, g=g, hd=hd, ps=ps,
                        num_pages=24, p_cap=5, dtype=torch.float32,
                        dead_row=True)
                    got = pa.paged_decode(q, k, v, pages, lens, window=window)
                    want = pa.paged_decode_plain(q, k, v, pages, lens,
                                                 window=window)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    check(err <= tol_f32, f"paged_decode hd={hd} ps={ps} "
                          f"kv={kv} g={g} window={window}: max abs err "
                          f"{err} > {tol_f32}")
                    check(bool((got[-1] == 0).all()) and bool(
                        (got[1] == 0).all()), "paged_decode: an all-sentinel "
                          "or length-0 row is not exact zeros")
                    worst = max(worst, err)
                    n_cases += 1
    # negative entries read page 0 (the TPU kernel's clip); sentinels mask
    q, k, v, pages, lens = decode_case(11, b=4, kv=2, g=4, hd=128, ps=4,
                                       num_pages=24, p_cap=6,
                                       dtype=torch.float32)
    lens[0], lens[2], lens[3] = 24, 17, 9
    pages[0, :] = torch.tensor([3, -1, 5, 24, -7, 2], dtype=torch.int32)
    pages[2, :5] = torch.tensor([-2, 7, 30, 1, 0], dtype=torch.int32)
    err_neg = float((pa.paged_decode(q, k, v, pages, lens)
                     - pa.paged_decode_plain(q, k, v, pages, lens))
                    .abs().max())
    check(err_neg <= tol_f32, f"paged_decode negative entries: {err_neg} "
          f"> {tol_f32}")
    # ---- full width, the shapes the main path gives the kernel
    c = SERVE
    max_len = c["prompt_max"] + c["new_tokens"] + 1
    num_pages = -(-c["capacity"] * max_len // c["page_size"])
    p_cap = min(-(-2 * max_len // c["page_size"]), num_pages)
    full = dict(b=c["capacity"], kv=8, g=5, hd=128, ps=c["page_size"],
                num_pages=num_pages, p_cap=p_cap,
                max_len=c["prompt_max"] + c["new_tokens"])
    q, k, v, pages, lens = decode_case(7, dtype=torch.float32, **full)
    got = pa.paged_decode(q, k, v, pages, lens)
    want = pa.paged_decode_plain(q, k, v, pages, lens)
    err_full32 = float((got - want).abs().max())
    check(err_full32 <= tol_f32,
          f"paged_decode full width f32: {err_full32} > {tol_f32}")
    splits, pps, _ = decode_plan(q, pages)
    model = pa.paged_decode_split_model(q, k, v, pages, lens,
                                        pages_per_split=pps)
    err_model = float((got - model).abs().max())
    check(err_model <= tol_f32, f"paged_decode vs its split model "
          f"({splits} splits): {err_model} > {tol_f32}")
    q, k, v, pages, lens = decode_case(8, dtype=torch.bfloat16, **full)
    got = pa.paged_decode(q, k, v, pages, lens)
    ok, err_bf16 = within_bf16(got, pa.paged_decode_plain(
        q, k, v, pages, lens), tol_bf16)
    check(ok, f"paged_decode full width bf16: max abs err {err_bf16} "
          f"beyond {tol_bf16} + 1 ulp")
    check(bits_equal(got, pa.paged_decode(q, k, v, pages, lens)),
          "paged_decode full width: two launches differ")
    main = time_decode(q, k, v, pages, lens)
    # ---- long context: 4 rows x 4096 live positions, 64 MB of K+V
    ps, per_row, b = 16, 256, 4
    q, k, v, _, _ = decode_case(9, b=b, kv=8, g=5, hd=128, ps=ps,
                                num_pages=b * per_row, p_cap=1,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(9)
    pages = torch.randperm(b * per_row, generator=gen).to(
        torch.int32).reshape(b, per_row).to("cuda")
    lens = torch.full((b,), per_row * ps, dtype=torch.int32, device="cuda")
    got = pa.paged_decode(q, k, v, pages, lens)
    ok, err_long = within_bf16(got, pa.paged_decode_plain(
        q, k, v, pages, lens), tol_bf16)
    check(ok, f"paged_decode long context bf16: max abs err {err_long} "
          f"beyond {tol_bf16} + 1 ulp")
    check(bits_equal(got, pa.paged_decode(q, k, v, pages, lens)),
          "paged_decode long context: two launches differ")
    long_row = time_decode(q, k, v, pages, lens)
    long_row.update(max_abs_err=err_long, shape={
        "b": b, "kv": 8, "g": 5, "hd": 128, "ps": ps,
        "num_pages": b * per_row, "p_cap": per_row, "len": per_row * ps})
    return {"cases_f32": n_cases, "max_abs_err_f32": worst,
            "max_abs_err_negative_entries": err_neg,
            "max_abs_err_full_f32": err_full32,
            "max_abs_err_split_model": err_model, "max_abs_err": err_bf16,
            "tol_f32": tol_f32, "tol_bf16": f"{tol_bf16} + 1 bf16 ulp",
            "bit_equal_launches": True,
            "shape": dict(full), "dtype": "bfloat16", **main,
            "library": "F.scaled_dot_product_attention on the gathered view",
            "long_context": long_row, "hd256": check_decode_hd256(),
            "jamba": check_decode_jamba()}


def gemma_cell():
    """gemma3-1b's serving settings in phase 10 (phase 4's, with two
    prompts past the 512-token window: the longest sets max_len)."""
    return dict(SERVE, prompt_max=max(FAMILY_LONG_PROMPTS))


def check_decode_hd256():
    """gemma3-1b's decode shape (hd 256, one kv head, G 4, window 512 on
    its local layers) on the card: bf16 at the shape phase 10's engine
    gives the kernel (B 4, one row past the window, one empty) with and
    without the window, held to the plain version and to the split
    model, two launches bit-equal, timed; the long row (B 4 x 4096
    positions) with and without the window, timed; f32 at both shapes
    within 1e-5."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import paged_attention as pa
    cfg = get_arch("gemma3-1b")
    kv, g, hd = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                 cfg.resolved_head_dim)
    tol_f32, tol_bf16, window = 1e-5, 2e-3, cfg.sliding_window
    c = gemma_cell()
    max_len = c["prompt_max"] + c["new_tokens"] + 1
    num_pages = -(-c["capacity"] * max_len // c["page_size"])
    p_cap = min(-(-2 * max_len // c["page_size"]), num_pages)
    shape = dict(b=c["capacity"], kv=kv, g=g, hd=hd, ps=c["page_size"],
                 num_pages=num_pages, p_cap=p_cap,
                 max_len=c["prompt_max"] + c["new_tokens"])
    res, errs = {"shape": dict(shape, window=window)}, {}

    def held(q, k, v, pages, lens, w, what):
        got = pa.paged_decode(q, k, v, pages, lens, window=w)
        want = pa.paged_decode_plain(q, k, v, pages, lens, window=w)
        torch.cuda.synchronize()
        if q.dtype == torch.float32:
            err = float((got - want).abs().max())
            ok = err <= tol_f32
        else:
            ok, err = within_bf16(got, want, tol_bf16)
            check(bits_equal(got, pa.paged_decode(q, k, v, pages, lens,
                                                  window=w)),
                  f"paged_decode hd 256 {what}: two launches differ")
        check(ok, f"paged_decode hd 256 {what}: max abs err {err} beyond "
              f"{tol_f32 if q.dtype == torch.float32 else tol_bf16}")
        check(int(lens[1]) != 0 or bool((got[1] == 0).all()),
              f"paged_decode hd 256 {what}: a length-0 row is not zeros")
        errs[what] = err

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, pages, lens = decode_case(12, dtype=dtype, **shape)
        lens[0] = c["prompt_max"]          # one row past the window
        need = -(-c["prompt_max"] // c["page_size"])
        pages[0, :need] = torch.randperm(
            num_pages, generator=torch.Generator().manual_seed(12))[
            :need].to(device="cuda", dtype=torch.int32)
        name = "f32" if dtype == torch.float32 else "bf16"
        for w in (window, None):
            held(q, k, v, pages, lens, w, f"{name} window {w}")
        if dtype == torch.bfloat16:
            splits, pps, ctas = decode_plan(q, pages)
            model = pa.paged_decode_split_model(
                q, k, v, pages, lens, pages_per_split=pps, window=window)
            ok, errs["bf16 split model"] = within_bf16(
                pa.paged_decode(q, k, v, pages, lens, window=window), model,
                tol_bf16)
            check(ok, "paged_decode hd 256 vs its split model: "
                  f"{errs['bf16 split model']}")
            res.update(time_decode(q, k, v, pages, lens, window))
            res["lens"] = lens.tolist()
            res["no_window"] = time_decode(q, k, v, pages, lens)
    # the long row: 4 rows x 4096 live positions
    ps, per_row, b = 16, 256, 4
    gen = torch.Generator(device="cpu").manual_seed(13)
    pages = torch.randperm(b * per_row, generator=gen).to(
        torch.int32).reshape(b, per_row).to("cuda")
    lens = torch.full((b,), per_row * ps, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, _ = decode_case(13, b=b, kv=kv, g=g, hd=hd, ps=ps,
                                    num_pages=b * per_row, p_cap=1,
                                    dtype=dtype)
        name = "f32" if dtype == torch.float32 else "bf16"
        for w in (window, None):
            held(q, k, v, pages, lens, w, f"{name} long window {w}")
        if dtype == torch.bfloat16:
            res["long_window"] = time_decode(q, k, v, pages, lens, window)
            res["long"] = time_decode(q, k, v, pages, lens)
    res["long_shape"] = {"b": b, "kv": kv, "g": g, "hd": hd, "ps": ps,
                         "num_pages": b * per_row, "p_cap": per_row,
                         "len": per_row * ps}
    res["max_abs_err"] = errs
    res["tol"] = {"f32": tol_f32, "bf16": f"{tol_bf16} + 1 bf16 ulp"}
    return res


def check_decode_jamba():
    """jamba-1.5-large-398b's attention layer at the shape phase 12's
    engine gives the kernel (phase 4's settings: B 4, 8 kv heads, G 8,
    hd 128, page 16) in bf16: held to the plain version within 2e-3 + 1
    ulp, two launches bit-equal, timed beside its bound and SDPA."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import paged_attention as pa
    cfg = get_arch("jamba-1.5-large-398b")
    kv, g, hd = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                 cfg.resolved_head_dim)
    tol_bf16 = 2e-3
    c = SERVE
    max_len = c["prompt_max"] + c["new_tokens"] + 1
    num_pages = -(-c["capacity"] * max_len // c["page_size"])
    p_cap = min(-(-2 * max_len // c["page_size"]), num_pages)
    shape = dict(b=c["capacity"], kv=kv, g=g, hd=hd, ps=c["page_size"],
                 num_pages=num_pages, p_cap=p_cap,
                 max_len=c["prompt_max"] + c["new_tokens"])
    q, k, v, pages, lens = decode_case(14, dtype=torch.bfloat16, **shape)
    got = pa.paged_decode(q, k, v, pages, lens)
    ok, err = within_bf16(got, pa.paged_decode_plain(q, k, v, pages, lens),
                          tol_bf16)
    check(ok, f"paged_decode jamba shape bf16: max abs err {err} beyond "
          f"{tol_bf16} + 1 ulp")
    check(bits_equal(got, pa.paged_decode(q, k, v, pages, lens)),
          "paged_decode jamba shape: two launches differ")
    return {"shape": shape, "dtype": "bfloat16", "max_abs_err": err,
            "tol": f"{tol_bf16} + 1 bf16 ulp", "lens": lens.tolist(),
            **time_decode(q, k, v, pages, lens)}


def chain_ms(n_steps, cycles_per_step, clock_mhz):
    """Dependent-chain estimate (not the roofline bound): ``n_steps``
    steps of a recurrence, each waiting ``cycles_per_step`` cycles, at
    the card's maximum SM clock."""
    if not clock_mhz:
        return None
    return n_steps * cycles_per_step / (clock_mhz * 1e3)


def admission_trace(rng, n, ties):
    """Random sorted arrivals, or the engine's tie-heavy shape: in-flight
    holds all arriving "now", the queue just after."""
    import numpy as np
    if ties:
        arr = np.concatenate([np.zeros(n // 2), 1e-3 * (np.arange(
            n - n // 2) + 1)]).astype(np.float32)
        hold = rng.integers(1, 9, n).astype(np.float32)
    else:
        arr = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
        hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
    return arr, hold


def median_us(fn, reps: int = 200) -> float:
    """Median host-clock time in µs of ``fn``, which synchronises itself,
    over ``reps`` calls after ten warm ones."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def plan_anatomy(run_c, window, library, library_ref):
    """Where a planning call's host time goes at N 12 on the 32-wide
    window (median of 200, µs): the C plan entry with its packing, on
    buffers of the script's own (copy in, launch, copy out, synchronise),
    the window planner around it (padding,
    packing, unpadding), the sync library's plan on ``cuda`` around that,
    and the same library plan on ``ref`` (the plain version on the host,
    the yardstick of this host's speed)."""
    return {"c_plan": median_us(run_c), "window": median_us(window),
            "library_cuda": median_us(library),
            "library_ref": median_us(library_ref)}


def saturating_trace(rng, n):
    """Sorted arrivals inside one hold: past K of them, they wait."""
    import numpy as np
    return (np.sort(rng.uniform(0.0, 0.5, n)).astype(np.float32),
            rng.integers(1, 9, n).astype(np.float32))


def check_semaphore(launch_floor_ms, clock_mhz):
    """Bit-identical to the plain version on N {1, 64, 128, 1000} x K {1,
    4, 8, 9, 32, 33, 64, 1024} over random and tie-heavy traces, and past
    the register layout (the column kernel) at K 1025 and 2048 on
    saturating traces of N 64 and K + 300 and through a planning window;
    timed at the main path's shape (the engine's 64-wide planning window
    at capacity 4), with the kernel alone at K 33 and 1024 beside it and
    at K 1024 / 1025 / 2048 on N 64 and N 1324 / 1325 / 2348."""
    import numpy as np
    import torch
    from repro_torch.kernels import semaphore as sem
    from repro_torch.kernels.build import PlanStaging
    rng = np.random.default_rng(0)
    n_checked = 0
    for n in (1, 64, 128, 1000):
        for cap in (1, 4, 8, 9, 32, 33, 64, 1024):
            for ties in (False, True):
                arr, hold = admission_trace(rng, n, ties)
                a_t = torch.tensor(arr, device="cuda")
                h_t = torch.tensor(hold, device="cuda")
                got = sem.semaphore_admission(a_t, h_t, cap)
                want = sem.semaphore_admission_plain(a_t.cpu(), h_t.cpu(),
                                                     cap)
                for x, y, name in zip(got, want, ("grant", "release",
                                                  "waited")):
                    check(bits_equal(x, y), f"semaphore_admission N={n} "
                          f"K={cap} ties={ties}: {name} differs")
                n_checked += 1
    past = {}
    for cap in (1024, 1025, 2048):
        for n in (64, cap + 300):
            arr, hold = saturating_trace(rng, n)
            a_t, h_t = (torch.tensor(x, device="cuda") for x in (arr, hold))
            got = sem.semaphore_admission(a_t, h_t, cap)
            want = sem.semaphore_admission_plain(a_t.cpu(), h_t.cpu(), cap)
            for x, y, name in zip(got, want, ("grant", "release",
                                              "waited")):
                check(bits_equal(x, y), f"semaphore_admission N={n} "
                      f"K={cap}: {name} differs")
            n_checked += 1
            past[f"k{cap}_n{n}"] = {
                "waited": int(want[2].sum()),
                "kernel_ms": kernel_ms(lambda: sem.semaphore_admission(
                    a_t, h_t, cap), "semaphore_admission_kernel", reps=5)}
    arr, hold = saturating_trace(rng, 2100)
    got = sem.AdmissionWindow("cuda", base_window=4096)(arr, hold,
                                                       capacity=2048)
    want = sem.AdmissionWindow("cpu", base_window=4096)(arr, hold,
                                                       capacity=2048)
    check(all(bits_equal(torch.tensor(np.asarray(x)),
                         torch.tensor(np.asarray(y)))
              for x, y in zip(got, want)),
          "semaphore window plan at K 2048 differs from the plain version")
    # main-path shape: the engine's planning window (64) at capacity 4
    n, cap = 64, SERVE["capacity"]
    arr, hold = admission_trace(rng, n, False)
    a_t, h_t = (torch.tensor(x, device="cuda") for x in (arr, hold))
    ms = cuda_ms(lambda: sem.semaphore_admission(a_t, h_t, cap), flush_mb=1)
    name = "semaphore_admission_kernel"
    k_ms = kernel_ms(lambda: sem.semaphore_admission(a_t, h_t, cap), name)
    by_capacity = {k: kernel_ms(lambda: sem.semaphore_admission(
        a_t, h_t, k), name) for k in (33, 1024)}
    a_c, h_c = a_t.cpu(), h_t.cpu()
    plain_ms = plain_host_ms(
        lambda: sem.semaphore_admission_plain(a_c, h_c, cap))
    window = sem.AdmissionWindow("cuda", base_window=64)
    call_ms = host_ms(lambda: window(arr[:40], hold[:40], capacity=cap))
    from repro_torch.sync import SyncLibrary
    lib = SyncLibrary.host_default()
    small = sem.AdmissionWindow("cuda")
    a12, h12 = arr[:12], hold[:12]
    stage = PlanStaging(torch.device("cuda"), 2 * 32, 3 * 32)
    anatomy = plan_anatomy(
        lambda: stage.run(sem.SEMAPHORE_ADMISSION, (arr[:32], hold[:32]),
                          32, cap, 0),
        lambda: small(a12, h12, capacity=cap),
        lambda: lib.plan_semaphore(a12, h12, cap, backend="cuda"),
        lambda: lib.plan_semaphore(a12, h12, cap, backend="ref"))
    nbytes = 5 * n * 4
    ops = float(n * (cap + 2))
    bms, bby = bound_ms(nbytes, ops, "float32")
    return {
        "traces": n_checked, "bit_identical": True, "max_abs_err": 0.0,
        "shape": {"n": n, "capacity": cap}, "ms": ms, "kernel_ms": k_ms,
        "kernel_ms_n64_by_capacity": by_capacity,
        "past_register_capacity": past,
        "plain_ms": plain_ms, "plain_on": "host (numpy loop)",
        "call_ms": call_ms,
        "call": "AdmissionWindow plan of 40 arrivals on the 64-wide "
                "window, host clock",
        "plan_anatomy_us_n12": anatomy,
        "launch_floor_ms": launch_floor_ms,
        "chain_estimate_ms": chain_ms(n, SEMAPHORE_STEP_CYCLES, clock_mhz),
        "chain_estimate": f"{SEMAPHORE_STEP_CYCLES} cycles per arrival "
                          "(a redux minimum, a ballot, the insert and the "
                          "new key, at assumed latencies) at the max SM "
                          "clock; an estimate, not the bound",
        "bound_ms": bms, "bound_by": bby,
        "bytes": nbytes, "ops": ops, "library_ms": None}


def phase_kernels(out):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    res["paged_decode"] = check_paged_decode()

    # the floor a one-warp sequential kernel really meets: one launch of
    # a one-element kernel on the same stream
    one = torch.zeros(1, device="cuda")
    launch_floor_ms = cuda_ms(lambda: one.add_(1.0), flush_mb=1)
    clock_mhz = out.get("sm_clock_mhz")
    res["semaphore_admission"] = check_semaphore(launch_floor_ms, clock_mhz)
    res["ticket_lock"] = check_ticket_lock(launch_floor_ms, clock_mhz)
    res["xf_barrier"] = check_xf_barrier(launch_floor_ms, clock_mhz)
    res["membench"] = check_membench(launch_floor_ms)
    out["kernels"] = res
    return res


def plain_host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of a plain version that runs on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def bits_equal(a, b) -> bool:
    import numpy as np
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bfloat16:       # numpy has no bf16: compare bits
        a, b = a.view(torch.int16), b.view(torch.int16)
    a, b = a.numpy(), b.numpy()
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def check_ticket_lock(launch_floor_ms, clock_mhz):
    """Grant order and turn trace exact, the chain bit-equal, error word
    never set, over four seeded permutations at each N {1, 33, 64, 1024,
    4096} (4096: each of the CTA's 32 requester warps serves 128
    requesters) and one at N 16385 and 32768, past the shared-memory
    staging. Timed at N 64 (the kernel benchmark's shape) and 1024, and
    the kernel alone at N 16384 (staged) beside 16385 and 32768."""
    import numpy as np
    import torch
    from repro_torch.kernels import ticket_lock as tl
    from repro_torch.kernels.build import PlanStaging
    rng = np.random.default_rng(3)
    n_checked = 0
    timing = {}

    def inputs(n):
        return (torch.tensor(rng.permutation(n), dtype=torch.int32,
                             device="cuda"),
                torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32,
                             device="cuda"),
                torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                             device="cuda"))

    for n in (1, 33, 64, 1024, 4096):
        for _ in range(4):
            arr, m, b = inputs(n)
            got = tl.ticket_lock(arr, m, b)
            want = tl.ticket_lock_plain(arr.cpu(), m.cpu(), b.cpu())
            for g, w, name in zip(got, want, ("grant", "trace", "acc")):
                check(bits_equal(g, w), f"ticket_lock N={n}: {name} "
                      f"differs from the plain version")
            n_checked += 1
    past = {}
    for n in (tl.STAGED_N, tl.STAGED_N + 1, 2 * tl.STAGED_N):
        arr, m, b = inputs(n)
        if n > tl.STAGED_N:
            got = tl.ticket_lock(arr, m, b)
            want = tl.ticket_lock_plain(arr.cpu(), m.cpu(), b.cpu())
            for g, w, name in zip(got, want, ("grant", "trace", "acc")):
                check(bits_equal(g, w), f"ticket_lock N={n}: {name} "
                      f"differs from the plain version")
            n_checked += 1
        past[f"n{n}"] = {"kernel_ms": kernel_ms(lambda: tl.ticket_lock(
            arr, m, b, check=False), "ticket_lock_kernel", reps=3)}
        tl.TICKET_LOCK.check_pending()
    for n in (64, 1024):
        arr, m, b = inputs(n)
        a_c, m_c, b_c = arr.cpu(), m.cpu(), b.cpu()
        timing[n] = {
            "ms": cuda_ms(lambda: tl.ticket_lock(arr, m, b, check=False),
                          reps=20, flush_mb=1),
            "kernel_ms": kernel_ms(lambda: tl.ticket_lock(
                arr, m, b, check=False), "ticket_lock_kernel"),
            "plain_ms": plain_host_ms(
                lambda: tl.ticket_lock_plain(a_c, m_c, b_c)),
            "chain_estimate_ms": chain_ms(n, LOCK_STEP_CYCLES, clock_mhz)}
        tl.TICKET_LOCK.check_pending()
    window_call_ms = host_ms(lambda: tl.ticket_lock_window(
        np.arange(12, dtype=np.int32), device="cuda"))
    from repro_torch.sync import SyncLibrary
    lib = SyncLibrary.host_default()
    perm12 = rng.permutation(12).astype(np.int32)
    stage = PlanStaging(torch.device("cuda"), 3 * 32, 2 * 32 + 2)
    perm32 = rng.permutation(32).astype(np.int32)
    ones, zeros = np.ones(32, np.float32), np.zeros(32, np.float32)
    anatomy = plan_anatomy(
        lambda: stage.run(tl.TICKET_LOCK, (perm32, ones, zeros), 32),
        lambda: tl.ticket_lock_window(perm12, device="cuda"),
        lambda: lib.plan_mutex(perm12, backend="cuda"),
        lambda: lib.plan_mutex(perm12, backend="ref"))
    n = 64
    nbytes = 5 * n * 4 + 4        # arrival, m, b in; grant, trace, acc out
    ops = 2.0 * n                 # one multiply and one add per requester
    bms, bby = bound_ms(nbytes, ops, "float32")
    return {"traces": n_checked, "bit_identical": True, "max_abs_err": 0.0,
            "shape": {"n": n},
            "ms": timing[n]["ms"], "kernel_ms": timing[n]["kernel_ms"],
            "plain_ms": timing[n]["plain_ms"], "plain_on": "host (numpy loop)",
            "call_ms": window_call_ms,
            "call": "ticket_lock_window of 12 requesters on the 32-wide "
                    "window, host clock",
            "plan_anatomy_us_n12": anatomy,
            "n1024": timing[1024], "past_staging": past,
            "launch_floor_ms": launch_floor_ms,
            "chain_estimate_ms": timing[n]["chain_estimate_ms"],
            "chain_estimate": f"{LOCK_STEP_CYCLES} cycles per requester (a "
                              "turn hand-off through shared memory and the "
                              "critical section) at the max SM clock; an "
                              "estimate, not the bound",
            "bound_ms": bms, "bound_by": bby, "bytes": nbytes, "ops": ops,
            "library_ms": None,
            "library": "none: no PyTorch call computes a lock timeline"}


def barrier_cases(rng, n):
    """(name, arrive, present, required, epoch): everyone; ~10 % absent;
    rank 0 absent and required; rank 0 absent and not required; random
    masks over stale flags from earlier epochs."""
    import numpy as np
    ones = np.ones(n, np.int32)
    absent = (rng.uniform(size=n) < 0.1).astype(np.int32)
    absent[rng.integers(n)] = 1
    no0 = ones.copy()
    no0[0] = 0
    stale = rng.integers(0, 4, n).astype(np.int32)
    return [("all", np.zeros(n, np.int32), ones, ones, 1),
            ("stragglers", np.zeros(n, np.int32), 1 - absent, ones, 1),
            ("rank0_absent", np.zeros(n, np.int32), no0, ones, 1),
            ("rank0_absent_not_required", np.zeros(n, np.int32), no0, no0,
             1),
            ("random", stale, (rng.uniform(size=n) < 0.9).astype(np.int32),
             (rng.uniform(size=n) < 0.8).astype(np.int32), 3)]


def barrier_latency_ms(n, clock_mhz):
    """Latency estimate of one epoch (not the bound): BARRIER_CYCLES for
    the input loads, two __syncthreads, an arrival, the fence and the
    output stores, plus BARRIER_CHUNK_CYCLES per 128-word chunk of the
    master's two scans (present flags, then required ones), at the
    card's maximum SM clock."""
    return chain_ms(1, BARRIER_CYCLES + 2 * BARRIER_CHUNK_CYCLES
                    * -(-n // 128), clock_mhz)


def check_xf_barrier(launch_floor_ms, clock_mhz):
    """Every output bit-equal to the plain version and the error word
    never set, over seeded epochs at N {1, 64, 1024, 4096, 32768} and,
    with the flags in global memory, {32769, 65536}, with poll budgets
    {0, 1, 1024}, and everyone present at N 64 and 1024 with
    a budget of 0 or 1 fifty times each (a master that scanned before a
    present participant's store would report done = 0 there). Timed at
    N 64 (the kernel benchmark's shape) and 1024, with and without a
    straggler; the kernel alone, everyone present, at N 32768 beside
    32769 and 65536; the plan call's anatomy at N 12."""
    import numpy as np
    import torch
    from repro_torch.kernels import xf_barrier as xb
    from repro_torch.kernels.build import PlanStaging
    rng = np.random.default_rng(4)
    n_checked = 0
    done_seen = {0: 0, 1: 0}
    sizes = (1, 64, 1024, 4096, xb.SHARED_N, xb.SHARED_N + 1,
             2 * xb.SHARED_N)

    def same(n, arrive, present, required, epoch, max_polls, what):
        a, p, r = (torch.tensor(x, device="cuda")
                   for x in (arrive, present, required))
        got = xb.xf_barrier(a, epoch, p, r, max_polls=max_polls)
        want = xb.xf_barrier_plain(a.cpu(), epoch, p.cpu(), r.cpu())
        for g, w, name in zip(got, want, ("arrive", "release", "done",
                                          "stragglers")):
            check(bits_equal(g, w), f"xf_barrier N={n} {what} max_polls="
                  f"{max_polls}: {name} differs from the plain version")
        return int(want[2])

    for n in sizes:
        for _ in range(4 if n <= 1024 else 1):
            for name, arrive, present, required, epoch in barrier_cases(
                    rng, n):
                for max_polls in (0, 1, 1024):
                    done_seen[same(n, arrive, present, required, epoch,
                                   max_polls, name)] += 1
                    n_checked += 1
    for n in (64, 1024):
        ones = np.ones(n, np.int32)
        for max_polls in (0, 1):
            for _ in range(50):
                done_seen[same(n, 0 * ones, ones, ones, 1, max_polls,
                               "all")] += 1
                n_checked += 1
    past = {}
    for n in (xb.SHARED_N, xb.SHARED_N + 1, 2 * xb.SHARED_N):
        ones = torch.ones(n, dtype=torch.int32, device="cuda")
        flags = torch.zeros(n, dtype=torch.int32, device="cuda")
        past[f"n{n}"] = {"kernel_ms": kernel_ms(lambda: xb.xf_barrier(
            flags, 1, ones, ones, check=False), "xf_barrier_kernel",
            reps=5)}
        xb.XF_BARRIER.check_pending()
    timing = {}
    for n in (64, 1024):
        ones = torch.ones(n, dtype=torch.int32, device="cuda")
        flags = torch.zeros(n, dtype=torch.int32, device="cuda")
        absent = ones.clone()
        absent[n // 2] = 0
        f_c, o_c = flags.cpu(), ones.cpu()
        timing[n] = {
            "ms": cuda_ms(lambda: xb.xf_barrier(flags, 1, ones, ones,
                                                check=False),
                          reps=20, flush_mb=1),
            "kernel_ms": kernel_ms(lambda: xb.xf_barrier(
                flags, 1, ones, ones, check=False), "xf_barrier_kernel"),
            "plain_ms": cuda_ms(lambda: xb.xf_barrier_plain(
                flags, 1, ones, ones), reps=20, flush_mb=1),
            "plain_cpu_ms": plain_host_ms(
                lambda: xb.xf_barrier_plain(f_c, 1, o_c, o_c)),
            "straggler_kernel_ms": kernel_ms(lambda: xb.xf_barrier(
                flags, 1, absent, ones, check=False), "xf_barrier_kernel",
                reps=5),
            "latency_estimate_ms": barrier_latency_ms(n, clock_mhz)}
        xb.XF_BARRIER.check_pending()
    z12, o12 = np.zeros(12, np.int32), np.ones(12, np.int32)
    call_ms = host_ms(lambda: xb.xf_barrier_window(z12, 1, o12, o12,
                                                   device="cuda"))
    from repro_torch.sync import SyncLibrary
    lib = SyncLibrary.host_default()
    stage = PlanStaging(torch.device("cuda"), 3 * 32, 3 * 32 + 2)
    z32, o32 = np.zeros(32, np.int32), np.ones(32, np.int32)
    anatomy = plan_anatomy(
        lambda: stage.run(xb.XF_BARRIER, (z32, o32, o32), 1, 1024, 32),
        lambda: xb.xf_barrier_window(z12, 1, o12, o12, device="cuda"),
        lambda: lib.plan_barrier(o12, epoch=1, backend="cuda"),
        lambda: lib.plan_barrier(o12, epoch=1, backend="ref"))
    n = 64
    nbytes = 6 * n * 4 + 8   # arrive, present, required in; 3 out, done, error
    bms, bby = bound_ms(nbytes, 0.0, "float32")
    return {"epochs": n_checked, "done_1": done_seen[1],
            "done_0": done_seen[0], "exact": True, "error_word_set": False,
            "sizes": list(sizes), "max_polls": [0, 1, 1024],
            "max_abs_err": 0.0,
            "shape": {"n": n, "max_polls": 1024}, "ms": timing[n]["ms"],
            "kernel_ms": timing[n]["kernel_ms"],
            "plain_ms": timing[n]["plain_ms"], "plain_on": "card (torch)",
            "plain_cpu_ms": timing[n]["plain_cpu_ms"],
            "straggler_kernel_ms": timing[n]["straggler_kernel_ms"],
            "latency_estimate_ms": timing[n]["latency_estimate_ms"],
            "latency_estimate": f"{BARRIER_CYCLES} cycles plus "
                                f"{BARRIER_CHUNK_CYCLES} per 128-word "
                                "chunk of the master's two scans, at "
                                "assumed latencies and the max SM clock; "
                                "an estimate, not the bound",
            "call_ms": call_ms,
            "call": "xf_barrier_window of 12 participants on the 32-wide "
                    "window, host clock",
            "plan_anatomy_us_n12": anatomy,
            "n1024": timing[1024], "past_shared_memory": past,
            "launch_floor_ms": launch_floor_ms,
            "bound_ms": bms, "bound_by": bby, "bytes": nbytes, "ops": 0.0,
            "library_ms": None,
            "library": "none: no PyTorch call computes a barrier epoch"}


def membench_library(buf, n_steps, contentious, write, repeats):
    """The one torch expression that computes a cell's result (timed as
    the yardstick, never called by the port)."""
    import torch
    dev = buf.device
    steps = torch.arange(n_steps, device=dev)
    if not write:
        rows = torch.zeros_like(steps) if contentious else steps
        return lambda: repeats * buf[rows].sum(-1)
    if contentious:
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        return lambda: buf.index_fill(0, zero, float(repeats + n_steps - 1))
    vals = (repeats + steps).float()[:, None].expand(n_steps, buf.shape[1])
    return lambda: buf.index_copy(0, steps, vals)


def check_membench(launch_floor_ms):
    """All four cells at 132 and 1056 steps (1 and 8 CTAs per SM for the
    one-CTA-per-step cells), 1000 repeats: buffer exact, sums within rtol
    1e-6, and each cell timed with its plain version and library
    expression on the card. Beside the bound, each cell at 1056 steps
    carries its accesses' own traffic (steps x repeats x 512 B) and the
    rate its kernel time gives: information, not a bound."""
    import torch
    from repro_torch.kernels import membench as mb
    rtol = 1e-6
    cells = {}
    worst = 0.0
    for n_steps in (132, 1056):
        gen = torch.Generator(device="cuda").manual_seed(n_steps)
        buf = mb.make_buffer(n_steps, generator=gen, device="cuda")
        for cont in (True, False):
            for wr in (True, False):
                kw = dict(n_steps=n_steps, contentious=cont, write=wr,
                          repeats=1000)
                bk, sk = mb.membench(buf, **kw)
                br, sr = mb.membench_plain(buf, **kw)
                tag = f"{'c' if cont else 'n'}{'w' if wr else 'r'}"
                check(bits_equal(bk, br), f"membench {tag} n={n_steps}: "
                      f"buffer differs from the plain version")
                err = float(((sk - sr).abs() / sr.abs().clamp_min(1e-30))
                            .max())
                check(err <= rtol, f"membench {tag} n={n_steps}: sums off "
                      f"by rtol {err} > {rtol}")
                worst = max(worst, float((sk - sr).abs().max()))
                cell = {"rel_err": err,
                        "ms": cuda_ms(lambda: mb.membench(buf, **kw),
                                      reps=10, flush_mb=1),
                        "kernel_ms": kernel_ms(lambda: mb.membench(
                            buf, **kw), MEMBENCH_KERNELS, reps=10)
                        if n_steps == MEMBENCH_CELL["n_steps"] else None,
                        "plain_ms": cuda_ms(lambda: mb.membench_plain(
                            buf, **kw), reps=10, flush_mb=1),
                        "library_ms": cuda_ms(membench_library(buf, **kw),
                                              reps=10, flush_mb=1)}
                rows = buf.shape[0]
                cell["bytes"] = 2 * rows * mb.LANE * 4 + 4 * n_steps
                cell["ops"] = 0.0 if wr else float(n_steps * (mb.LANE + 1))
                cell["bound_ms"], cell["bound_by"] = bound_ms(
                    cell["bytes"], cell["ops"], "float32")
                cell["access_bytes"] = n_steps * kw["repeats"] * mb.LANE * 4
                cell["access_tb_per_s"] = (
                    cell["access_bytes"] / cell["kernel_ms"] / 1e9
                    if cell["kernel_ms"] else None)
                cells[f"{tag}_{n_steps}"] = cell
    row = cells[f"cr_{MEMBENCH_CELL['n_steps']}"]
    return {"cells": cells, "buffers_exact": True, "sums_rtol": rtol,
            "max_abs_err": worst, "launch_floor_ms": launch_floor_ms,
            "shape": {"cell": "contentious read", **MEMBENCH_CELL},
            "ms": row["ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "plain_on": "card (torch)", "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "repeats * buf[rows].sum(-1) (read cells); "
                       "index_fill / index_copy (write cells); not the "
                       "same work: no accesses per step"}


# ------------------------------------------------------ phases 3-4: serving
def make_requests(seed, c, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(
        c["prompt_min"], c["prompt_max"] + 1)), dtype=np.int32)
        for _ in range(c["requests"])]


def make_engine(model, params, c, device, **kw):
    """The main path's engine (paged, chunked prefill, fused decode,
    bucketed dispatch) unless ``kw`` overrides its settings."""
    from repro_torch.serve.engine import SlotServeEngine
    args = dict(capacity=c["capacity"],
                max_len=c["prompt_max"] + c["new_tokens"] + 1,
                kv_layout="paged", page_size=c["page_size"],
                prefill_chunk_tokens=c["prefill_chunk"],
                decode_chunk=c["decode_chunk"], attention_impl="fused",
                bucketed_dispatch="on", device=device)
    args.update(kw)
    return SlotServeEngine(model, params, **args)


#: The reference's default serving path (``--kv-layout slots``, one-shot
#: prefill): contiguous slot arena, gather-free contiguous decode.
SLOTS = dict(kv_layout="slots", prefill_chunk_tokens=None,
             attention_impl="gather", bucketed_dispatch="auto")


def serve(engine, prompts, new_tokens):
    """Submit all, drain, synchronise. Returns (requests, wall seconds)."""
    import torch
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def check_drained(engine, reqs, new_tokens, vocab, what, faulted=False):
    """Every request finished with its tokens (``new_tokens``, or each
    request's own budget when None) from the vocabulary, in FIFO grant
    order; paged, the pool (and the prefix cache, released after its
    own check) drains to no page in use. A run without a fault plan
    (``faulted`` False) injected nothing and retried no round."""
    check(all(r.state.value == "finished" and len(r.out_tokens) == (
        r.max_new_tokens if new_tokens is None else new_tokens)
        for r in reqs), f"{what}: a request did not finish with its tokens")
    check_pool(engine, reqs, vocab, what, faulted)


def check_pool(engine, reqs, vocab, what, faulted=False):
    """The checks of :func:`check_drained` that hold whatever state each
    request ended in: token ids, FIFO grants, no fault or retried round
    unless ``faulted``, and (paged) no page left in use."""
    check(all(0 <= t < vocab for r in reqs for t in r.out_tokens),
          f"{what}: token id out of the vocabulary")
    check(engine.grant_log == sorted(engine.grant_log),
          f"{what}: FIFO grant order violated: {engine.grant_log}")
    if not faulted:
        st = engine.stats()
        check(st["rounds_retried"] == 0 and st["faults_injected"] == 0,
              f"{what}: a fault-free run retried {st['rounds_retried']} "
              f"rounds, {st['faults_injected']} faults injected")
    if engine.kv_layout != "paged":
        return
    try:
        engine.pool.check()
        if engine.prefix_cache is not None:
            engine.prefix_cache.check()
        engine.drop_prefix_cache()
        engine.pool.check()
    except AssertionError as e:
        raise SmokeFailure(f"{what}: page pool inconsistent: {e}")
    check(engine.pool.pages.in_use == 0,
          f"{what}: {engine.pool.pages.in_use} pages leaked after drain")


def phase_parity(out):
    """Reduced qwen3-14b, float32, TF32 off: each engine configuration on
    cuda (CUDA kernels) and on cpu (plain versions), same weights and
    requests — the main path (paged, chunked, fused, bucketed), the slot
    arena one-shot and chunked, the paged arena one-shot with eager
    growth — then the four prefix runs (``prefix_parity``), and the
    legacy per-request engine on two requests."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    c = REDUCED
    prompts = make_requests(1, c, cfg.vocab_size)
    configs = {
        "paged_chunked_fused": {},
        "slots_oneshot": SLOTS,
        "slots_chunked": dict(SLOTS,
                              prefill_chunk_tokens=c["prefill_chunk"]),
        "paged_oneshot_eager": dict(prefill_chunk_tokens=None,
                                    page_growth="eager"),
    }
    res = {}
    for name, kw in configs.items():
        runs = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = make_engine(model, params, c, dev, **kw)
            reqs, dt = serve(eng, prompts, c["new_tokens"])
            check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                          f"reduced {name} {dev}")
            st = eng.stats()
            runs[dev] = ({r.rid: r.out_tokens for r in reqs}, eng.grant_log,
                         st.get("lock_acquires"))
        check(runs["cuda"][0] == runs["cpu"][0],
              f"reduced parity {name}: greedy streams differ between cuda "
              f"and cpu")
        check(runs["cuda"][1] == runs["cpu"][1],
              f"reduced parity {name}: grant logs differ between cuda and "
              f"cpu")
        check(runs["cuda"][2] == runs["cpu"][2],
              f"reduced parity {name}: allocator acquire counts differ")
        res[name] = {"streams_identical": True, "grant_log": runs["cuda"][1],
                     "lock_acquires": runs["cuda"][2]}
    res.update(prefix_parity(model, {"cuda": params_gpu, "cpu": params_cpu},
                             c, cfg.vocab_size))
    res.update(lifecycle_parity(model, {"cuda": params_gpu,
                                        "cpu": params_cpu},
                                c, cfg.vocab_size))
    res.update(family_parity(c))
    res.update(ssm_parity(c))
    res.update(sampling_parity(model, params_gpu, c, cfg.vocab_size))
    res.update(embedding_parity())
    res.update(train_parity())
    legacy = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = ServeEngine(model, params,
                          max_len=c["prompt_max"] + c["new_tokens"] + 1)
        legacy[dev] = [eng.generate(
            {"tokens": torch.tensor(p[None], device=dev)},
            c["new_tokens"]).tokens.cpu().tolist() for p in prompts[:2]]
    check(legacy["cuda"] == legacy["cpu"],
          "reduced parity legacy: tokens differ between cuda and cpu")
    res["legacy_2_requests"] = {"streams_identical": True}
    return {"requests": c["requests"], "configs": res}


def reduced_families():
    """Phase 3's reduced configs of phase 10's families, and gemma3-1b
    with two leftover layers after its one period (8 layers): name ->
    config."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfgs = {name: get_arch(name).reduced() for name, _, _ in FAMILIES}
    cfgs["gemma3-1b-leftover"] = dataclasses.replace(
        cfgs["gemma3-1b"], num_layers=8)
    return cfgs


def family_parity(c):
    """Each reduced family on the main path (paged, chunked, fused,
    bucketed, sharing as resolved) on cuda and on cpu from the same
    weights and requests: streams, grant logs and acquires identical."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    res = {}
    for name, cfg in reduced_families().items():
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        prompts = make_requests(1, c, cfg.vocab_size)
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = make_engine(model, params if dev == "cpu" else tree_map(
                lambda t: t.to(dev), params), c, dev)
            reqs, _ = serve(eng, prompts, c["new_tokens"])
            check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                          f"reduced {name} {dev}")
            runs[dev] = ({r.rid: r.out_tokens for r in reqs},
                         eng.grant_log, eng.stats()["lock_acquires"])
        check(runs["cuda"] == runs["cpu"],
              f"reduced parity {name}: streams, grant logs or acquires "
              f"differ between cuda and cpu")
        res[f"family_{name}"] = {"streams_identical": True,
                                 "grant_log": runs["cuda"][1],
                                 "lock_acquires": runs["cuda"][2]}
    return res


#: a recurrent model's engine: phase 4's arguments with bucketed dispatch
#: ``auto`` (``"on"`` raises for a mamba layer, as in the reference)
SSM_ENGINE = dict(bucketed_dispatch="auto")
#: the reduced recurrent decoders of phase 3: falcon-mamba, jamba's one
#: period (8 layers) and jamba at 4 layers (no whole period)
SSM_ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b")
#: the gates every recurrent or sampling engine resolves, as the
#: reference's: eager growth, no chunked prefill, no bucketing, no
#: sharing, no cache
RECURRENT_GATES = {"page_growth": "eager", "prefill_chunk": 0,
                   "bucketed_dispatch": False, "prefix_sharing": False,
                   "prefix_cache": False}
SAMPLE_T = 0.8


def engine_gates(eng):
    """The settings an engine resolved from its arguments."""
    return {"page_growth": eng.page_growth,
            "prefill_chunk": eng.prefill_chunk,
            "bucketed_dispatch": bool(eng.bucketed_dispatch),
            "prefix_sharing": bool(eng.prefix_sharing),
            "prefix_cache": eng.prefix_cache is not None}


def reduced_ssm():
    """name -> reduced config of each recurrent decoder of phase 3."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfgs = {name: get_arch(name).reduced() for name in SSM_ARCHS}
    cfgs["jamba-1.5-large-398b-4"] = dataclasses.replace(
        cfgs["jamba-1.5-large-398b"], num_layers=4)
    return cfgs


def ssm_parity(c):
    """Each reduced recurrent decoder on the phase-4 engine's arguments
    and on the slot arena, on cuda and on cpu from the same weights and
    requests: streams, grant logs, acquires and the resolved gates
    identical (the gates the reference's); the legacy engine on two
    requests."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import ServeEngine
    res = {}
    for name, cfg in reduced_ssm().items():
        model = build_model(cfg)
        params = {"cpu": model.init(torch.Generator().manual_seed(0), "cpu")}
        params["cuda"] = tree_map(lambda t: t.to("cuda"), params["cpu"])
        prompts = make_requests(1, c, cfg.vocab_size)
        for layout, kw in (("main", SSM_ENGINE), ("slots", SLOTS)):
            runs = {}
            for dev in ("cuda", "cpu"):
                eng = make_engine(model, params[dev], c, dev, **kw)
                reqs, _ = serve(eng, prompts, c["new_tokens"])
                check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                              f"reduced {name} {layout} {dev}")
                runs[dev] = ({r.rid: r.out_tokens for r in reqs},
                             eng.grant_log,
                             eng.stats().get("lock_acquires"),
                             engine_gates(eng))
            check(runs["cuda"] == runs["cpu"],
                  f"reduced parity {name} {layout}: streams, grant logs, "
                  f"acquires or gates differ between cuda and cpu")
            check(runs["cuda"][3] == RECURRENT_GATES,
                  f"reduced {name} {layout}: resolved {runs['cuda'][3]}")
            res[f"ssm_{name}_{layout}"] = {
                "streams_identical": True, "grant_log": runs["cuda"][1],
                "lock_acquires": runs["cuda"][2], "gates": runs["cuda"][3]}
        legacy = {}
        for dev in ("cuda", "cpu"):
            eng = ServeEngine(model, params[dev],
                              max_len=c["prompt_max"] + c["new_tokens"] + 1)
            legacy[dev] = [eng.generate(
                {"tokens": torch.tensor(p[None], device=dev)},
                c["new_tokens"]).tokens.cpu().tolist() for p in prompts[:2]]
        check(legacy["cuda"] == legacy["cpu"],
              f"reduced parity {name} legacy: tokens differ between cuda "
              f"and cpu")
        res[f"ssm_{name}_legacy_2_requests"] = {"streams_identical": True}
    return res


def sampled_run(model, params, c, prompts, device, n_tokens, fault_plan=None,
                what="sampled"):
    """The phase-4 engine's arguments at temperature SAMPLE_T, seed 0:
    the gates it resolved, every request finished, no page leaked; with
    a fault plan its failed rounds are retried (never quarantined).
    Returns (streams, stats)."""
    eng = make_engine(model, params, c, device, temperature=SAMPLE_T, seed=0,
                      fault_plan=fault_plan, retry_backoff_s=0.0,
                      quarantine_after=1000, **SSM_ENGINE)
    check(engine_gates(eng) == RECURRENT_GATES,
          f"{what}: resolved {engine_gates(eng)}")
    reqs, _ = serve(eng, prompts, n_tokens)
    check_drained(eng, reqs, n_tokens, model.cfg.vocab_size, what,
                  faulted=fault_plan is not None)
    return [list(r.out_tokens) for r in reqs], eng.stats()


def sampling_parity(model, params, c, vocab):
    """Reduced qwen3-14b sampled on the card twice from seed 0 (streams
    identical), then under a dispatch-fault plan (streams equal to the
    fault-free run's: the retry replays the generator's draws)."""
    from repro_torch.serve.faults import FaultPlan
    prompts = make_requests(1, c, vocab)
    a, _ = sampled_run(model, params, c, prompts, "cuda", c["new_tokens"])
    b, _ = sampled_run(model, params, c, prompts, "cuda", c["new_tokens"])
    check(a == b, "sampled runs of one seed differ on the card")
    plan = FaultPlan(11, dispatch_rate=0.3)
    f, st = sampled_run(model, params, c, prompts, "cuda", c["new_tokens"],
                        fault_plan=plan, what="sampled, dispatch faults")
    check(st["rounds_retried"] >= 1 and plan.by_kind.get("dispatch", 0),
          f"sampled, dispatch faults: {st['rounds_retried']} rounds retried")
    check(st["requests_quarantined"] == 0,
          "sampled, dispatch faults: a request was quarantined")
    check(f == a, "sampled, dispatch faults: streams differ from the "
          "fault-free run")
    return {"sampled_qwen3": {"temperature": SAMPLE_T, "seed": 0,
                              "same_seed_identical": True,
                              "faults_replayed_identical": True,
                              "rounds_retried": st["rounds_retried"],
                              "dispatch_faults": plan.by_kind.get(
                                  "dispatch", 0)}}


def phase_serve(out):
    """Full-width qwen3-14b (published dims, bf16, random weights drawn
    on the card) through the main path; the launch counters are zeroed
    just before the run and read just after."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    from repro_torch.models import build_model
    cfg = get_arch("qwen3-14b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    c = SERVE
    prompts = make_requests(2, c, cfg.vocab_size)
    eng = make_engine(model, params, c, "cuda")
    PAGED_DECODE.launches = 0
    SEMAPHORE_ADMISSION.launches = 0
    reqs, dt = serve(eng, prompts, c["new_tokens"])
    launches = {"paged_decode": PAGED_DECODE.launches,
                "semaphore_admission": SEMAPHORE_ADMISSION.launches}
    check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size, "full width")
    check(launches["paged_decode"] > 0 and launches["paged_decode"]
          == attention_layers(cfg) * eng.decode_steps_run,
          f"paged_decode launched {launches['paged_decode']} times, want "
          f"{attention_layers(cfg)} x {eng.decode_steps_run} decode steps")
    check(launches["semaphore_admission"] > 0,
          "semaphore_admission never launched on the main path")
    check(eng.grant_log == list(range(c["requests"])),
          f"full width: grant log {eng.grant_log}")
    # finite logits of the full-width model on a one-row cache
    cache = model.init_cache(2, c["page_size"], "cuda")
    cache["len"] = torch.zeros(1, dtype=torch.int32, device="cuda")
    cache["pages"] = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    logits, _ = model.decode_step(
        params, cache, torch.tensor([1], dtype=torch.int32, device="cuda"),
        attn_impl="fused")
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "full width: decode logits not finite")
    st = eng.stats()
    out["launches"] = launches
    out["serve"] = st
    out["phase4_streams"] = {r.rid: r.out_tokens for r in reqs}
    # phase 7 serves the same requests with these weights
    out["serve_weights"] = (model, params, prompts,
                            {r.rid: r.out_tokens for r in reqs})
    return {"arch": cfg.name, "params": n_params, "init_s": init_s,
            "settings": c, "wall_s": dt, "tokens": st["tokens"],
            "tok_per_s": st["tokens"] / dt, "rounds": eng.step_clock,
            "decode_steps": eng.decode_steps_run,
            "prefill_chunks": st["prefill_chunks"], "launches": launches,
            "lock_acquires": st["lock_acquires"],
            "lock_acquires_per_token": st["lock_acquires_per_token"],
            "semaphore_admitted": st["semaphore_admitted"],
            "semaphore_completed": st["semaphore_completed"],
            "page_pauses": st["page_pauses"],
            "page_preemptions": st["page_preemptions"],
            "prefix_sharing": st["prefix_sharing"],
            "prefix_hits": st["prefix_hits"],
            "dispatch_shapes": st["dispatch_shapes"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_slots(out):
    """Full-width qwen3-14b through the reference's default serving path:
    ``SlotServeEngine(kv_layout="slots")``, one-shot prefill, decode
    chunk 2, serving phase 4's 8 requests (capacity 4, the same prompts,
    16 new tokens) with phase 4's weights; then the legacy per-request
    loop on the first 2. The launch counters are zeroed just before the
    slots run and read just after; the share of tokens equal to phase
    4's paged streams is information (bf16 at full width may flip an
    argmax tie between the two layouts), not a check."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = get_arch("qwen3-14b")
    if "serve_weights" in out:
        model, params, prompts, paged = out["serve_weights"]
    else:                      # run without phase 4: the same draw
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        prompts, paged = make_requests(2, SERVE, cfg.vocab_size), None
    c = SERVE
    eng = make_engine(model, params, c, "cuda", **dict(SLOTS,
                                                       decode_chunk=2))
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    reqs, dt = serve(eng, prompts, c["new_tokens"])
    launches = {name: k.launches for name, k in counters.items()}
    check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                  "full width slots")
    check(launches["semaphore_admission"] > 0,
          "semaphore_admission never launched on the slots path")
    check(eng.grant_log == list(range(c["requests"])),
          f"full width slots: grant log {eng.grant_log}")
    st = eng.stats()
    out["launches_slots"] = launches
    same = total = first = 0
    prefix = []
    if paged is not None:
        for r in reqs:
            mine, theirs = r.out_tokens, paged[r.rid]
            total += len(mine)
            same += sum(a == b for a, b in zip(mine, theirs))
            first += int(mine[0] == theirs[0])
            k = 0
            while k < len(mine) and mine[k] == theirs[k]:
                k += 1
            prefix.append(k)
    # the legacy loop: one request after the other, batch 1
    legacy = ServeEngine(model, params,
                         max_len=c["prompt_max"] + c["new_tokens"] + 1)
    t0 = time.perf_counter()
    legacy_tokens = []
    for p in prompts[:2]:
        toks = legacy.generate({"tokens": torch.tensor(p[None],
                                                       device="cuda")},
                               c["new_tokens"]).tokens
        legacy_tokens.append(toks.cpu().tolist()[0])
    torch.cuda.synchronize()
    legacy_s = time.perf_counter() - t0
    check(all(len(t) == c["new_tokens"]
              and all(0 <= x < cfg.vocab_size for x in t)
              for t in legacy_tokens), "legacy loop: bad token stream")
    legacy_same = sum(a == b for t, r in zip(legacy_tokens, reqs[:2])
                      for a, b in zip(t, r.out_tokens))
    # finite logits of a full-width one-shot prefill
    logits, cache = model.prefill(
        params, {"tokens": torch.tensor(prompts[0][None], device="cuda")},
        max_len=c["prompt_max"] + c["new_tokens"] + 1)
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "full width: prefill logits not finite")
    del cache
    return {"arch": cfg.name, "kv_layout": "slots", "prefill": "one-shot",
            "decode_chunk": 2, "requests": c["requests"],
            "new_tokens": c["new_tokens"], "wall_s": dt,
            "tokens": st["tokens"], "tok_per_s": st["tokens"] / dt,
            "rounds": st["decode_dispatches"], "step_clock": eng.step_clock,
            "decode_steps": eng.decode_steps_run,
            "prefill_tokens": st["prefill_tokens"],
            "pad_tokens": st["pad_tokens"],
            "decode_rounds_stalled_by_prefill":
                st["decode_rounds_stalled_by_prefill"],
            "launches": launches,
            "p50_wait_steps": st["p50_wait_steps"],
            "p99_wait_steps": st["p99_wait_steps"],
            "tokens_equal_to_paged": (same / total) if total else None,
            "first_tokens_equal_to_paged": first if total else None,
            "common_prefix_with_paged": prefix,
            "legacy": {"requests": 2, "wall_s": legacy_s,
                       "tokens": 2 * c["new_tokens"],
                       "tok_per_s": 2 * c["new_tokens"] / legacy_s,
                       "tokens_equal_to_slots": legacy_same
                       / (2 * c["new_tokens"])},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


# ------------------------------------------------- phases 3 and 8: prefixes
#: the sharing and cache counts a prefix run reports and compares
PREFIX_COUNTS = ("prefix_hits", "shared_pages_adopted", "cow_splits",
                 "cache_hits", "prefill_tokens_saved", "cache_pages_evicted")


def serve_trace(engine, arrivals):
    """Submit each ``(step, prompt, new_tokens)`` once the step clock
    reaches its step (the clock idles forward while nothing runs) and
    drain. Returns (requests in arrival order, scheduler rounds, wall
    seconds ending in a synchronise)."""
    import torch
    t0 = time.perf_counter()
    pending = sorted(arrivals, key=lambda a: a[0])
    reqs, rounds = [], 0
    while pending or engine.queue or engine.active:
        while pending and pending[0][0] <= engine.step_clock:
            _, prompt, n = pending.pop(0)
            reqs.append(engine.submit(prompt, n))
        if engine.queue or engine.active:
            engine.step()
            rounds += 1
        else:
            engine.step_clock += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, rounds, time.perf_counter() - t0


def next_turn(reqs, follows, new_tokens):
    """Each request's prompt + reply + its follow-up tokens, all arriving
    at once."""
    import numpy as np
    return [(0, np.concatenate([r.prompt, np.asarray(r.out_tokens, np.int32),
                                f]).astype(np.int32), new_tokens)
            for r, f in zip(reqs, follows)]


def reduced_prefix_runs(vocab):
    """Phase 3's prefix runs on the reduced main path: name ->
    (engine overrides, drive(engine) -> requests, counts that must be
    above 0)."""
    import numpy as np
    rng = np.random.default_rng(4)
    a = rng.integers(1, vocab, 10).astype(np.int32)
    head = rng.integers(1, vocab, 8)
    b1, b2 = (np.concatenate([head, rng.integers(1, vocab, 4)]).astype(
        np.int32) for _ in range(2))
    donor = rng.integers(1, vocab, 9).astype(np.int32)
    turn1 = rng.integers(1, vocab, 9).astype(np.int32)
    follow = rng.integers(1, vocab, 5).astype(np.int32)
    distinct = [rng.integers(1, vocab, 11).astype(np.int32)
                for _ in range(5)]

    def sharing(eng):
        return serve_trace(eng, [(0, a, 6), (6, a, 6), (8, b1, 5),
                                 (14, b2, 5)])[0]

    def split(eng):
        return serve_trace(eng, [(0, donor, 10), (2, donor, 10)])[0]

    def two_turns(eng):
        r1 = serve_trace(eng, [(0, turn1, 7)])[0]
        return r1 + serve_trace(eng, next_turn(r1, [follow], 5))[0]

    def watermark(eng):
        return serve_trace(eng, [(0, p, 4) for p in distinct])[0]
    return {
        "sharing_repeat_and_boundary": (
            dict(prefix_sharing="on"), sharing,
            ("prefix_hits", "shared_pages_adopted", "prefill_tokens_saved")),
        "donor_split_partial_page": (
            dict(prefix_sharing="on", prefill_chunk_tokens=None,
                 page_size=8, capacity=2, max_len=32), split,
            ("prefix_hits", "cow_splits")),
        "cache_two_turns": (
            dict(prefix_cache="on", max_len=64), two_turns,
            ("cache_hits", "prefill_tokens_saved")),
        "watermark_eviction": (
            dict(prefix_cache="on", num_pages=14, max_len=32, capacity=2),
            watermark, ("cache_pages_evicted",)),
    }


def prefix_parity(model, params_by_dev, c, vocab):
    """Phase 3's prefix runs on each device: streams, grant logs,
    allocator acquires and the sharing and cache counts identical
    between them, and each run's own counts above 0."""
    res = {}
    for name, (kw, drive, positive) in reduced_prefix_runs(vocab).items():
        runs = {}
        for dev, params in params_by_dev.items():
            eng = make_engine(model, params, c, dev, **kw)
            reqs = drive(eng)
            st = eng.stats()
            check_drained(eng, reqs, None, vocab, f"reduced {name} {dev}")
            runs[dev] = ({r.rid: r.out_tokens for r in reqs}, eng.grant_log,
                         st["lock_acquires"],
                         {k: st.get(k, 0.0) for k in PREFIX_COUNTS})
        first, *rest = runs.values()
        check(all(r == first for r in rest),
              f"reduced parity {name}: streams, grant logs, acquires or "
              f"prefix counts differ between devices: "
              f"{ {d: r[1:] for d, r in runs.items()} }")
        check(all(first[3][k] > 0 for k in positive),
              f"reduced {name}: want {positive} above 0, got {first[3]}")
        res[name] = {"identical": True, "grant_log": first[1],
                     "lock_acquires": first[2], **first[3]}
    return res


def prefix_traffic(vocab, p):
    """Phase 8's prompts and second-turn follow-ups (numpy seed 3): a
    common preamble plus a uniform suffix each; request ``repeat[1]``
    repeats request ``repeat[0]`` exactly, at a length that is not a
    multiple of the page size 16 (nor of 4, the reduced one)."""
    import numpy as np
    rng = np.random.default_rng(3)
    pre = rng.integers(0, vocab, p["preamble"])
    prompts = [np.concatenate([pre, rng.integers(0, vocab, int(rng.integers(
        p["suffix_min"], p["suffix_max"] + 1)))]).astype(np.int32)
        for _ in range(p["requests"])]
    i, j = p["repeat"]
    if prompts[i].size % 16 == 0:
        prompts[i] = prompts[i][:-1]
    if prompts[i].size % 4 == 0:
        prompts[i] = prompts[i][:-1]
    prompts[j] = prompts[i].copy()
    follows = [rng.integers(0, vocab, p["follow"]).astype(np.int32)
               for _ in range(p["requests"])]
    return prompts, follows


def prefix_cell(model, params, c, p, device, vocab):
    """Phase 8's runs (also callable at a reduced size on the CPU):
    turn 1 on the main path with sharing on and off, turn 1 on its
    one-shot variant with sharing on, and turns 1 and 2 with the prefix
    cache on. Returns ``(engines, per-run records)``; checks every run
    drained, the counts each run exists to show, and that sharing adds
    no allocator acquire."""
    prompts, follows = prefix_traffic(vocab, p)
    max_len = (p["preamble"] + p["suffix_max"] + 2 * p["new_tokens"]
               + p["follow"] + 1)
    turn1 = [(p["gap"] * k, q, p["new_tokens"]) for k, q in
             enumerate(prompts)]
    runs = {"sharing_on": dict(), "sharing_off": dict(prefix_sharing="off"),
            "oneshot_sharing_on": dict(prefill_chunk_tokens=None),
            "cache_on": dict(prefix_cache="on")}
    engines, rec = {}, {}
    for name, kw in runs.items():
        eng = make_engine(model, params, c, device, max_len=max_len, **kw)
        reqs, rounds, dt = serve_trace(eng, turn1)
        turns = {"turn1": (reqs, rounds, dt)}
        if name == "cache_on":
            turns["turn2"] = serve_trace(eng, next_turn(
                reqs, follows, p["new_tokens"]))
        st = eng.stats()
        all_reqs = [r for t in turns.values() for r in t[0]]
        check_drained(eng, all_reqs, None, vocab, f"prefix {name}")
        check(eng.grant_log == [r.rid for r in all_reqs],
              f"prefix {name}: grant log {eng.grant_log}")
        engines[name] = eng
        rec[name] = {
            "streams": {r.rid: list(r.out_tokens) for r in all_reqs},
            "wall_s": {t: v[2] for t, v in turns.items()},
            "tok_per_s": {t: sum(len(r.out_tokens) for r in v[0]) / v[2]
                          for t, v in turns.items()},
            "rounds": sum(v[1] for v in turns.values()),
            "decode_steps": eng.decode_steps_run,
            "lock_acquires": st["lock_acquires"],
            "acquires_per_round": st["lock_acquires"] / max(
                sum(v[1] for v in turns.values()), 1),
            "pages_alloced": st["pages_alloced"],
            **{k: st.get(k, 0.0) for k in PREFIX_COUNTS}}
    on, off = rec["sharing_on"], rec["sharing_off"]
    check(on["shared_pages_adopted"] > 0 and on["prefill_tokens_saved"] > 0,
          f"prefix sharing_on: nothing adopted or skipped: {on}")
    one = rec["oneshot_sharing_on"]
    check(one["shared_pages_adopted"] > 0 and one["cow_splits"] > 0,
          f"prefix oneshot_sharing_on: no adoption or no split: {one}")
    cache = rec["cache_on"]
    check(cache["cache_hits"] > 0 and cache["prefill_tokens_saved"] > 0,
          f"prefix cache_on: no cache hit or nothing skipped: {cache}")
    # sharing rides the existing sections: no more acquires in all, and
    # at most the three sections a round has (admission, page prep,
    # retirement). Per round is reported, not compared: skipped chunks
    # shorten the run, so the same acquires spread over fewer rounds.
    check(on["lock_acquires"] <= off["lock_acquires"],
          f"prefix: sharing added allocator acquires ({on['lock_acquires']} "
          f"in {on['rounds']} rounds vs {off['lock_acquires']} in "
          f"{off['rounds']})")
    check(all(r["acquires_per_round"] <= 3 for r in rec.values()),
          f"prefix: more than 3 allocator acquires a round: "
          f"{ {n: r['acquires_per_round'] for n, r in rec.items()} }")
    return engines, rec


def phase_prefix(out):
    """Full-width qwen3-14b with phase 4's weights through the phase-4
    engine with prefix sharing and the prefix cache (``prefix_cell``);
    the launch counters are zeroed just before the runs and read just
    after: the decode kernel must have run 40 times a decode step, the
    admission kernel at least once. The share of turn-1 tokens equal
    with sharing on and off is information (bf16 at full width: a shifted
    chunk boundary can flip an argmax), not a check."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("qwen3-14b")
    if "serve_weights" in out:
        model, params, _, _ = out["serve_weights"]
    else:                      # run without phase 4: the same draw
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    engines, rec = prefix_cell(model, params, SERVE, PREFIX, "cuda",
                               cfg.vocab_size)
    launches = {name: k.launches for name, k in counters.items()}
    steps = sum(e.decode_steps_run for e in engines.values())
    check(launches["paged_decode"] == attention_layers(cfg) * steps,
          f"prefix: paged_decode launched {launches['paged_decode']} times, "
          f"want {attention_layers(cfg)} x {steps} decode steps")
    check(launches["semaphore_admission"] > 0,
          "semaphore_admission never launched on the prefix path")
    out["launches_prefix"] = launches
    on, off = rec["sharing_on"]["streams"], rec["sharing_off"]["streams"]
    total = sum(len(v) for v in on.values())
    same = sum(a == b for rid in on for a, b in zip(on[rid], off[rid]))
    del engines
    return {"arch": cfg.name, "settings": PREFIX, "engine": SERVE,
            "launches": launches, "decode_steps": steps,
            "turn1_tokens_equal_on_off": same / total,
            "runs": {n: {k: v for k, v in r.items() if k != "streams"}
                     for n, r in rec.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


# ------------------------------------------------ phases 3 and 9: lifecycle
#: the lifecycle counts a run reports and phase 3 compares across devices
LIFECYCLE_COUNTS = ("finished", "cancelled", "expired", "failed",
                    "rounds_retried", "aborted_batches",
                    "requests_quarantined", "lock_acquires")
#: chaos: every transient fault kind at rate 0.2, at most 3 of each, the
#: stuck holder past the allocator watchdog (the fields the launcher's
#: ``make_fault_plan`` / ``make_engine`` set, with caps)
CHAOS = dict(alloc_rate=0.2, dispatch_rate=0.2, stuck_rate=0.2,
             stuck_hold_s=5e-3, max_per_kind={"alloc": 3, "dispatch": 3,
                                              "stuck": 3})
WATCHDOG_S = 1e-3
# Phase 9's open loop: the launcher's --open-loop at phase 4's engine
# settings; 16 clients, Poisson arrivals, a quarter hanging up, an
# executor FaultPlan of rate 0.2 (at most 3 deaths).
OPEN_LOOP = dict(requests=16, prompt_len=128, new_tokens=16,
                 arrival_rate=4.0, cancel_rate=0.25, deadline_ms=4000.0,
                 slo_ms=2000.0, intake_limit=8, executor_rate=0.2,
                 executor_cap=3)


def lifecycle_plan(prompts, c):
    """Who does what in the cancel-and-deadline run, from the prompt
    lengths alone: of the first ``capacity`` requests (the first wave),
    the longest prompt is cancelled after its first prefill chunk, the
    next longest after its 4th token, and the shortest carries a step
    deadline one step past its last chunk, which it passes while
    decoding; request n - 2 is cancelled in the queue and the FIFO-last
    carries step deadline 2."""
    n, k, C = len(prompts), c["capacity"], c["prefill_chunk"]
    wave = sorted(range(k), key=lambda i: (-prompts[i].size, i))
    late = wave[-1]
    return {"prefilling": wave[0], "decoding": wave[1], "late": late,
            "late_deadline": -(-prompts[late].size // C) + 1,
            "queued": n - 2, "expire": n - 1}


def drive_lifecycle(engine, prompts, new_tokens, plan):
    """The cancel-and-deadline run: submit all at step 0 (with the
    plan's deadlines), cancel the queued victim at once, then after
    every round the prefilling and decoding victims as they reach their
    states. Returns (requests, {victim: state when cancelled}, whether
    the late row was seen late while decoding)."""
    reqs = []
    for i, p in enumerate(prompts):
        dl = (2 if i == plan["expire"] else plan["late_deadline"]
              if i == plan["late"] else None)
        reqs.append(engine.submit(p, new_tokens, deadline_step=dl))
    seen = {"queued": reqs[plan["queued"]].state.value}
    check(engine.cancel(reqs[plan["queued"]].rid), "cancel of a queued rid")
    late_decoding = False
    while engine.queue or engine.active or engine._cancel_pending:
        engine.step()
        pf, dec = reqs[plan["prefilling"]], reqs[plan["decoding"]]
        if ("prefilling" not in seen and pf.state.value == "prefilling"
                and pf.prefill_chunks >= 1):
            seen["prefilling"] = pf.state.value
            engine.cancel(pf.rid)
        if "decoding" not in seen and len(dec.out_tokens) >= 4:
            seen["decoding"] = dec.state.value
            engine.cancel(dec.rid)
        late = reqs[plan["late"]]
        if late.state.value == "decoding" and any(
                d["late"] for d in engine.slot_deadlines().values()
                if int(d["rid"]) == late.rid):
            late_decoding = True
    return reqs, seen, late_decoding


def lifecycle_record(engine, reqs):
    st = engine.stats()
    fp = engine.fault_plan
    return {"streams": {r.rid: list(r.out_tokens) for r in reqs},
            "states": {r.rid: r.state.value for r in reqs},
            "grant_log": list(engine.grant_log),
            **{k: st.get(k, 0.0) for k in LIFECYCLE_COUNTS},
            "faults_by_kind": dict(fp.by_kind) if fp is not None else {},
            "watchdog_trips": st.get("watchdog_trips", 0.0),
            "decode_steps": engine.decode_steps_run}


def lifecycle_fault_plan(name):
    """The FaultPlan of each lifecycle run (None: fault-free)."""
    from repro_torch.serve.faults import FaultPlan
    if name == "chaos":
        return FaultPlan(0, **CHAOS)
    if name == "dispatch_only":
        return FaultPlan(0, dispatch_rate=CHAOS["dispatch_rate"],
                         max_per_kind={"dispatch": 3})
    if name == "poison":
        return FaultPlan(0, poison_rid=3)      # the 4th request
    return None


def lifecycle_runs(model, params, c, prompts, device, vocab, names):
    """The lifecycle runs of phases 3 and 9 on the phase-4 engine
    (``make_engine``), each checked on its own: ``baseline`` (no fault
    plan), ``cancel_deadline``, ``chaos``, ``dispatch_only`` and
    ``poison``. Returns ``{name: record}``; every pool drains, and on the
    card each run launched the decode kernel once a layer a decode step
    (an aborted or failed round launches nothing)."""
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    new = c["new_tokens"]
    rec = {}
    for name in names:
        launched = PAGED_DECODE.launches
        fp = lifecycle_fault_plan(name)
        eng = make_engine(model, params, c, device, fault_plan=fp,
                          allocator_watchdog_s=(WATCHDOG_S if fp else None))
        what = f"lifecycle {name} {device}"
        if name == "cancel_deadline":
            plan = lifecycle_plan(prompts, c)
            reqs, seen, late_decoding = drive_lifecycle(eng, prompts, new,
                                                        plan)
            check(seen == {"queued": "queued", "prefilling": "prefilling",
                           "decoding": "decoding"},
                  f"{what}: victims cancelled in states {seen}")
            want = {plan["queued"]: "cancelled",
                    plan["prefilling"]: "cancelled",
                    plan["decoding"]: "cancelled", plan["expire"]: "expired"}
            check(all(r.state.value == want.get(i, "finished")
                      and (i in want or len(r.out_tokens) == new)
                      for i, r in enumerate(reqs)),
                  f"{what}: states { {r.rid: r.state.value for r in reqs} }")
            check(late_decoding,
                  f"{what}: the late row was never late while decoding")
            check(reqs[plan["expire"]].rid not in eng.grant_log
                  and reqs[plan["queued"]].rid not in eng.grant_log,
                  f"{what}: a request granted after its teardown")
        else:
            reqs = [eng.submit(p, new) for p in prompts]
            eng.run_until_done()
            want = {3: "failed"} if name == "poison" else {}
            check(all(r.state.value == want.get(i, "finished")
                      and (i in want or len(r.out_tokens) == new)
                      for i, r in enumerate(reqs)),
                  f"{what}: states { {r.rid: r.state.value for r in reqs} }")
            if name == "poison":
                check("injected fault" in (reqs[3].error or ""),
                      f"{what}: error {reqs[3].error!r}")
        check_pool(eng, reqs, vocab, what, faulted=fp is not None)
        r = rec[name] = lifecycle_record(eng, reqs)
        r["decode_launches"] = PAGED_DECODE.launches - launched
        if device == "cuda":
            check(r["decode_launches"]
                  == attention_layers(model.cfg) * eng.decode_steps_run,
                  f"{what}: paged_decode launched {r['decode_launches']} "
                  f"times for {eng.decode_steps_run} decode steps")
        kinds = r["faults_by_kind"]
        if name == "cancel_deadline":
            r["plan"] = plan
            check(r["cancelled"] == 3 and r["expired"] == 1,
                  f"{what}: {r['cancelled']} cancelled, {r['expired']} "
                  f"expired")
        elif name == "chaos":
            check(all(kinds.get(k, 0) >= 1
                      for k in ("alloc", "dispatch", "stuck")),
                  f"{what}: not every kind fired: {kinds}")
            check(r["rounds_retried"] >= kinds["dispatch"]
                  and r["aborted_batches"] >= 1
                  and r["watchdog_trips"] >= 1
                  and r["requests_quarantined"] == 0,
                  f"{what}: retried {r['rounds_retried']}, aborted "
                  f"{r['aborted_batches']}, watchdog {r['watchdog_trips']}, "
                  f"quarantined {r['requests_quarantined']}")
        elif name == "dispatch_only":
            check(kinds.get("dispatch", 0) >= 1
                  and r["rounds_retried"] == kinds["dispatch"],
                  f"{what}: {kinds}, retried {r['rounds_retried']}")
        elif name == "poison":
            check(r["requests_quarantined"] == 1
                  and r["rounds_retried"] >= eng.quarantine_after,
                  f"{what}: quarantined {r['requests_quarantined']}, "
                  f"retried {r['rounds_retried']}")
    return rec


def equal_share(a, b):
    """Share of ``a``'s tokens equal to ``b``'s, position by position."""
    total = sum(len(v) for v in a.values())
    same = sum(x == y for rid in a for x, y in zip(a[rid], b.get(rid, [])))
    return same / total if total else None


def lifecycle_parity(model, params_by_dev, c, vocab):
    """Phase 3's lifecycle runs on each device: streams, states, grant
    logs, acquires, the lifecycle counts and the faults by kind
    identical between them (the watchdog's trips follow the wall clock
    and are checked per run, not compared)."""
    prompts = make_requests(1, c, vocab)
    names = ("cancel_deadline", "chaos", "poison")
    runs = {dev: lifecycle_runs(model, params, c, prompts, dev, vocab, names)
            for dev, params in params_by_dev.items()}

    def keep(r):
        return {k: v for k, v in r.items()
                if k not in ("watchdog_trips", "decode_launches")}
    first, *rest = runs.values()
    res = {}
    for name in names:
        check(all(keep(r[name]) == keep(first[name]) for r in rest),
              f"reduced lifecycle {name}: runs differ between devices: "
              f"{ {d: keep(r[name]) for d, r in runs.items()} }")
        res[f"lifecycle_{name}"] = {
            "identical": True,
            **{k: v for k, v in first[name].items() if k != "streams"}}
    return res


def open_loop_cell(model, params, device, vocab, c, o):
    """Phase 9's open loop through the launcher's ``run_open_loop`` at
    the phase-4 engine's settings, with an executor FaultPlan. Checks
    every client is accounted for, the drain left no page, an executor
    death was survived, and each handle streamed exactly its request's
    tokens (a prefix of them when cancelled). Returns (engine, record)."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve.faults import FaultPlan
    args = launcher.parser().parse_args([
        "--arch", "qwen3-14b", "--requests", str(o["requests"]),
        "--capacity", str(c["capacity"]),
        "--prompt-len", str(o["prompt_len"]),
        "--new-tokens", str(o["new_tokens"]),
        "--decode-chunk", str(c["decode_chunk"]), "--kv-layout", "paged",
        "--page-size", str(c["page_size"]),
        "--prefill-chunk-tokens", str(c["prefill_chunk"]),
        "--attention-impl", "fused", "--bucketed-dispatch", "on",
        "--open-loop", "--arrival-rate", str(o["arrival_rate"]),
        "--cancel-rate", str(o["cancel_rate"]),
        "--deadline-ms", str(o["deadline_ms"]),
        "--slo-ms", str(o["slo_ms"]),
        "--intake-limit", str(o["intake_limit"]), "--seed", "0"])
    prompts = launcher.make_prompts(args, vocab)
    fp = FaultPlan(0, executor_rate=o["executor_rate"],
                   max_per_kind={"executor": o["executor_cap"]})
    records = []
    eng, _, report = launcher.run_open_loop(
        model, params, prompts, args, device, fault_plan=fp,
        records=records)
    st = eng.stats()
    what = f"open loop {device}"
    accounted = (report["finished"] + report["cancelled"] + report["expired"]
                 + report["shed"] + int(st["failed"]))
    check(accounted == o["requests"] and len(records) == o["requests"],
          f"{what}: {accounted} of {o['requests']} clients accounted for: "
          f"{report}")
    check(report["leaked_pages"] == 0, f"{what}: leaked pages {report}")
    check(fp.by_kind.get("executor", 0) >= 1,
          f"{what}: no executor death injected: {fp.by_kind}")
    for r in records:
        h = r["handle"]
        if h is None:
            check(r["shed"], f"{what}: client {r['i']} has no handle")
            continue
        full = list(h.req.out_tokens) if h.req is not None else []
        check(r["tokens"] == h.out_tokens == full[:len(r["tokens"])]
              and (h.state.value != "finished" or r["tokens"] == full),
              f"{what}: client {r['i']} streamed {r['tokens']}, its "
              f"request holds {full}")
    check(eng.grant_log == sorted(eng.grant_log),
          f"{what}: FIFO grant order violated")
    states = [r["handle"].state.value if r["handle"] is not None else "shed"
              for r in records]
    return eng, {"report": report, "failed": st["failed"],
                 "executor_faults": fp.by_kind.get("executor", 0),
                 "rounds_retried": st["rounds_retried"],
                 "decode_steps": eng.decode_steps_run,
                 "states": {k: states.count(k) for k in sorted(set(states))}}


def phase_lifecycle(out):
    """The request lifecycle at full width with phase 4's weights, on the
    phase-4 engine: phase 4's traffic cancelled in each state with step
    deadlines; under seeded chaos (allocator aborts, dispatch failures,
    stuck holders past the watchdog); with dispatch faults only, whose
    retried rounds have the fault-free shapes, so its streams must equal
    the fault-free run's when that run reproduces itself; with a
    poisoned request; and the launcher's open loop with executor deaths.
    The launch counters are zeroed just before the runs and read just
    after: the decode kernel ran 40 times a decode step (an aborted
    round launches nothing), the admission kernel at least once. The
    shares of tokens equal to the fault-free run are information where
    batch composition changed (bf16), not checks."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("qwen3-14b")
    if "serve_weights" in out:
        model, params, prompts, phase4 = out["serve_weights"]
    else:                      # run without phase 4: the same draw
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        prompts, phase4 = make_requests(2, SERVE, cfg.vocab_size), None
    names = ("baseline", "cancel_deadline", "chaos", "dispatch_only",
             "poison")
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    rec = lifecycle_runs(model, params, SERVE, prompts, "cuda",
                         cfg.vocab_size, names)
    runs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ol = open_loop_cell(model, params, "cuda", cfg.vocab_size, SERVE,
                           OPEN_LOOP)
    open_loop_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    steps = sum(r["decode_steps"] for r in rec.values()) + ol["decode_steps"]
    check(launches["paged_decode"] == attention_layers(cfg) * steps,
          f"lifecycle: paged_decode launched {launches['paged_decode']} "
          f"times, want {attention_layers(cfg)} x {steps} decode steps")
    check(launches["semaphore_admission"] > 0,
          "semaphore_admission never launched on the lifecycle path")
    out["launches_lifecycle"] = launches
    base = rec["baseline"]["streams"]
    # the fault-free run must reproduce itself (phase 4 ran it first;
    # without phase 4 it runs a second time here) before the dispatch-
    # only streams can be held to it
    again = phase4 if phase4 is not None else lifecycle_runs(
        model, params, SERVE, prompts, "cuda", cfg.vocab_size,
        ("baseline",))["baseline"]["streams"]
    reproduced = again == base
    disp = rec["dispatch_only"]["streams"]
    if reproduced:
        check(disp == base, f"lifecycle dispatch_only: streams differ from "
              f"the fault-free run ({equal_share(disp, base)} equal)")
    return {"arch": cfg.name, "engine": SERVE, "chaos": CHAOS,
            "open_loop_settings": OPEN_LOOP, "launches": launches,
            "decode_steps": steps, "runs_wall_s": runs_s,
            "open_loop_wall_s": open_loop_s,
            "fault_free_reproduced": reproduced,
            "fault_free_equal_share": equal_share(base, again),
            "dispatch_only_equal_share": equal_share(disp, base),
            "chaos_equal_share": equal_share(rec["chaos"]["streams"], base),
            "runs": {n: {k: v for k, v in r.items() if k != "streams"}
                     for n, r in rec.items()},
            "open_loop": ol,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def family_prompts(vocab, n, long=()):
    """Phase 4's prompt draw for ``n`` requests (numpy seed 2), with
    prompts 2 and 5 replaced by prompts of the lengths ``long`` (numpy
    seed 5). Returns (prompts, settings with max_len to fit them)."""
    import numpy as np
    c = dict(SERVE, requests=n)
    prompts = make_requests(2, c, vocab)
    rng = np.random.default_rng(5)
    for i, n_tok in zip((2, 5), long):
        prompts[i] = rng.integers(0, vocab, size=n_tok, dtype=np.int32)
    return prompts, dict(c, prompt_max=max(len(p) for p in prompts))


def serve_family(arch, layers, n_requests):
    """One model of phase 10 at full width (bf16, random weights on the
    card from seed 0), depth cut to ``layers`` when given, through the
    phase-4 engine; the launch counters are zeroed just before the run
    and read just after."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    cfg = full = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(full, num_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    long = FAMILY_LONG_PROMPTS if cfg.sliding_window else ()
    prompts, c = family_prompts(cfg.vocab_size, n_requests, long)
    eng = make_engine(model, params, c, "cuda")
    PAGED_DECODE.launches = 0
    SEMAPHORE_ADMISSION.launches = 0
    reqs, dt = serve(eng, prompts, c["new_tokens"])
    launches = {"paged_decode": PAGED_DECODE.launches,
                "semaphore_admission": SEMAPHORE_ADMISSION.launches}
    check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size, arch)
    check(launches["paged_decode"] > 0 and launches["paged_decode"]
          == attention_layers(cfg) * eng.decode_steps_run,
          f"{arch}: paged_decode launched {launches['paged_decode']} times, "
          f"want {attention_layers(cfg)} x {eng.decode_steps_run} decode "
          f"steps")
    check(launches["semaphore_admission"] > 0,
          f"{arch}: semaphore_admission never launched")
    check(eng.grant_log == list(range(n_requests)),
          f"{arch}: grant log {eng.grant_log}")
    cache = model.init_cache(2, c["page_size"], "cuda")
    cache["len"] = torch.zeros(1, dtype=torch.int32, device="cuda")
    cache["pages"] = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    logits, _ = model.decode_step(
        params, cache, torch.tensor([1], dtype=torch.int32, device="cuda"),
        attn_impl="fused")
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: decode logits not finite")
    st = eng.stats()
    window = cfg.sliding_window
    rec = {"arch": arch, "layers": cfg.num_layers,
           "depth_cut": None if not layers else (
               f"{full.num_layers} -> {layers} layers: "
               f"{2 * count_params(build_model(full).spec_tree()) / 1e9:.0f}"
               f" GB of bf16 weights whole, over the card's 80 GB"),
           "params": count_params(model.spec_tree()), "init_s": init_s,
           "requests": n_requests,
           "prompt_lens": [len(p) for p in prompts],
           "rows_past_window": (None if not window else sum(
               len(p) + c["new_tokens"] > window for p in prompts)),
           "wall_s": dt, "tokens": st["tokens"],
           "tok_per_s": st["tokens"] / dt, "rounds": eng.step_clock,
           "decode_steps": eng.decode_steps_run,
           "prefill_chunks": st["prefill_chunks"],
           "lock_acquires": st["lock_acquires"],
           "lock_acquires_per_token": st["lock_acquires_per_token"],
           "all_finished": True, "pages_leaked": 0, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    return rec, launches


def phase_families(out):
    """The other attention-only decoders at full width (FAMILIES), one
    model on the card at a time: phase 4's qwen3-14b weights are freed
    first and each model before the next. Per model: tokens/s, acquires
    per token, every request finished, no page leaked, and launch
    counters showing the decode kernel in every layer of every decode
    step and the admission kernel."""
    import gc
    import torch
    out.pop("serve_weights", None)
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    check(before_gb < 1.0, f"phase 4's weights still hold {before_gb:.1f} "
          f"GB of the card")
    models, total = {}, {}
    for arch, layers, n in FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        rec, launches = serve_family(arch, layers, n)
        models[arch] = rec
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    out["launches_families"] = total
    return {"allocated_before_gb": before_gb, "settings": SERVE,
            "long_prompts": FAMILY_LONG_PROMPTS, "models": models,
            "launches": total}


# ------------------------------------------------------- phase 12: ssm
#: phase 12's models (arch, layers kept or None for full depth, requests)
#: on phase 4's settings. jamba-1.5-large-398b keeps 4 of its 72 layers
#: (attention + 3 mamba, MoE on layers 1 and 3): about 23 B parameters,
#: 46 GB in bf16; one whole 8-layer period holds about 77 GB of experts.
SSM_FULL = (("falcon-mamba-7b", None, 8), ("jamba-1.5-large-398b", 4, 4))
#: requests of the sampled runs on falcon-mamba's weights
SSM_SAMPLED_REQUESTS = 4
#: draws of the frequency check and its bound: 5e-3 is 3.16 standard
#: deviations of one category's frequency over 1e5 draws in the worst
#: case (p = 1/2); the smaller probabilities of a 65024-wide row spread
#: less
SAMPLE_DRAWS = 100_000
SAMPLE_BATCH = 5_000
SAMPLE_BOUND = 5e-3


def timed_engine(eng):
    """Wrap the engine's prefill and round dispatch so each call
    synchronises the card and adds its seconds; returns the running
    sums and call counts."""
    import torch
    acc = {"prefill_s": 0.0, "prefill_calls": 0, "dispatch_s": 0.0,
           "dispatch_calls": 0}

    def wrap(fn, key):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[key + "_s"] += time.perf_counter() - t0
            acc[key + "_calls"] += 1
            return r
        return timed

    eng._prefill_impl = wrap(eng._prefill_impl, "prefill")
    eng._dispatch = wrap(eng._dispatch, "dispatch")
    return acc


def serve_counting(engine, prompts, new_tokens):
    """:func:`serve`, counting the rounds that start with a queue (each
    plans its admission: one admission-kernel launch)."""
    import torch
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    queued = 0
    while engine.queue or engine.active:
        queued += bool(engine.queue)
        engine.step()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, queued


def serve_ssm(arch, layers, n_requests):
    """One recurrent decoder at full width (bf16, random weights drawn on
    the card from seed 0), depth cut to ``layers`` when given, through
    the phase-4 engine's arguments; the launch counters are zeroed just
    before the run and read just after. Returns (record, launches,
    model, params)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    cfg = full = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(full, num_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    c = dict(SERVE, requests=n_requests)
    prompts = make_requests(2, c, cfg.vocab_size)
    eng = make_engine(model, params, c, "cuda", **SSM_ENGINE)
    check(engine_gates(eng) == RECURRENT_GATES,
          f"{arch}: resolved {engine_gates(eng)}, want the reference's "
          f"{RECURRENT_GATES}")
    acc = timed_engine(eng)
    PAGED_DECODE.launches = 0
    SEMAPHORE_ADMISSION.launches = 0
    reqs, dt, queued = serve_counting(eng, prompts, c["new_tokens"])
    launches = {"paged_decode": PAGED_DECODE.launches,
                "semaphore_admission": SEMAPHORE_ADMISSION.launches}
    check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size, arch)
    check(eng.grant_log == list(range(n_requests)),
          f"{arch}: grant log {eng.grant_log}")
    n_attn = attention_layers(cfg)
    check(launches["paged_decode"] == n_attn * eng.decode_steps_run,
          f"{arch}: paged_decode launched {launches['paged_decode']} times, "
          f"want {n_attn} attention layers x {eng.decode_steps_run} decode "
          f"steps")
    check(queued > 0 and launches["semaphore_admission"] == queued,
          f"{arch}: semaphore_admission launched "
          f"{launches['semaphore_admission']} times, want one a round with "
          f"a queue ({queued})")
    cache = model.init_cache(2, c["page_size"], "cuda", state_batch=1)
    cache["len"] = torch.zeros(1, dtype=torch.int32, device="cuda")
    cache["pages"] = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    logits, _ = model.decode_step(
        params, cache, torch.tensor([1], dtype=torch.int32, device="cuda"),
        attn_impl="fused")
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: decode logits not finite")
    st = eng.stats()
    rec = {"arch": arch, "layers": cfg.num_layers,
           "attention_layers": n_attn,
           "depth_cut": None if not layers else (
               f"{full.num_layers} -> {layers} layers: "
               f"{2 * count_params(build_model(full).spec_tree()) / 1e9:.0f}"
               f" GB of bf16 weights whole, over the card's 80 GB"),
           "params": count_params(model.spec_tree()), "init_s": init_s,
           "requests": n_requests, "prompt_lens": [len(p) for p in prompts],
           "gates": engine_gates(eng), "wall_s": dt, "tokens": st["tokens"],
           "tok_per_s": st["tokens"] / dt, "rounds": eng.step_clock,
           "rounds_with_queue": queued,
           "decode_steps": eng.decode_steps_run,
           "prefill_tokens": st["prefill_tokens"],
           "pad_tokens": st["pad_tokens"],
           "prefill_s": acc["prefill_s"],
           "prefill_ms_per_token": (1e3 * acc["prefill_s"]
                                    / max(st["prefill_tokens"], 1)),
           "dispatch_rounds": acc["dispatch_calls"],
           "decode_ms_per_round": (1e3 * acc["dispatch_s"]
                                   / max(acc["dispatch_calls"], 1)),
           "lock_acquires": st["lock_acquires"],
           "lock_acquires_per_token": st["lock_acquires_per_token"],
           "all_finished": True, "pages_leaked": 0, "launches": launches}
    return rec, launches, model, params


def sampling_full(model, params):
    """Sampling on a full-width model's weights: SSM_SAMPLED_REQUESTS of
    phase 4's requests at SAMPLE_T twice from seed 0 (streams identical,
    every request finished, no page leaked); then SAMPLE_DRAWS draws of
    the engine's ``_sample`` from one fixed logits row of the vocabulary's
    width on the card, every category's frequency within SAMPLE_BOUND of
    ``softmax(logits / T)``."""
    import torch
    vocab = model.cfg.vocab_size
    c = dict(SERVE, requests=SSM_SAMPLED_REQUESTS)
    prompts = make_requests(2, c, vocab)
    t0 = time.perf_counter()
    a, _ = sampled_run(model, params, c, prompts, "cuda", c["new_tokens"],
                       what=f"{model.cfg.name} sampled")
    b, _ = sampled_run(model, params, c, prompts, "cuda", c["new_tokens"],
                       what=f"{model.cfg.name} sampled again")
    check(a == b, f"{model.cfg.name}: sampled runs of one seed differ")
    runs_s = time.perf_counter() - t0
    eng = make_engine(model, params, dict(c, capacity=1), "cuda",
                      temperature=SAMPLE_T, seed=0, **SSM_ENGINE)
    gen = torch.Generator(device="cuda").manual_seed(1)
    logits = 3.0 * torch.randn(vocab, generator=gen, device="cuda")
    counts = torch.zeros(vocab, dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH):
        draws = eng._sample(logits[None].expand(SAMPLE_BATCH, vocab))
        counts += torch.bincount(draws.long(), minlength=vocab).double()
    torch.cuda.synchronize()
    draws_s = time.perf_counter() - t0
    p = torch.softmax(logits.double() / SAMPLE_T, dim=-1)
    gap = float((counts / SAMPLE_DRAWS - p).abs().max())
    check(gap < SAMPLE_BOUND, f"{model.cfg.name}: sampled frequencies "
          f"{gap} from the softmax, bound {SAMPLE_BOUND}")
    return {"requests": SSM_SAMPLED_REQUESTS, "temperature": SAMPLE_T,
            "seed": 0, "same_seed_identical": True, "runs_s": runs_s,
            "tokens_per_run": sum(len(s) for s in a),
            "draws": SAMPLE_DRAWS, "width": vocab,
            "max_frequency_gap": gap, "bound": SAMPLE_BOUND,
            "top_probability": float(p.max()), "draws_s": draws_s}


def phase_ssm(out):
    """The recurrent decoders at full width (SSM_FULL), one model on the
    card at a time after earlier weights are freed: falcon-mamba-7b at
    its published depth, then sampling on its weights, then jamba cut to
    4 layers. Per model: the gates resolved, every request finished,
    FIFO grants, no page leaked, the decode kernel once per attention
    layer of each decode step (none for falcon-mamba), the admission
    kernel once per round with a queue; tokens/s, prefill ms per token,
    ms per decode round and peak memory."""
    import gc
    import torch
    out.pop("serve_weights", None)
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    check(before_gb < 1.0, f"earlier weights still hold {before_gb:.1f} GB "
          f"of the card")
    models, total = {}, {}
    for arch, layers, n in SSM_FULL:
        torch.cuda.reset_peak_memory_stats()
        rec, launches, model, params = serve_ssm(arch, layers, n)
        if model.cfg.attention_free:
            rec["sampling"] = sampling_full(model, params)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        models[arch] = rec
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    out["launches_ssm"] = total
    return {"allocated_before_gb": before_gb, "settings": SERVE,
            "models": models, "launches": total}


# ------------------------------------- phases 3, 13, 14: encdec and training
#: phase 3's reduced embedding-family runs: whisper-small's legacy engine
#: on rows of frames, internvl2-76b's prefill and decode on embeddings
EMBED_REDUCED = dict(whisper_rows=3, whisper_frames=12, whisper_new=10,
                     internvl_rows=2, internvl_prompt=16, internvl_decode=8)
#: phase 3's reduced training run (gemma3-1b: five local layers and one
#: global) and the optimizer both packages' system tests use
TRAIN_REDUCED = dict(steps=3, batch=2, seq=24, seed=7)
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
#: phase 13 at published widths: whisper-small whole (4 requests of 1500
#: frames, 64 new tokens through the legacy engine) and internvl2-76b
#: cut to 8 of its 80 layers (2 rows of 1024 embeddings, 16 decode steps)
ENCDEC = dict(whisper_requests=4, whisper_frames=1500, whisper_new=64,
              internvl_layers=8, internvl_rows=2, internvl_prompt=1024,
              internvl_decode=16)
#: the reference's check of prefill + decode against forward
#: (tests/test_models_smoke.py): atol and rtol 2e-2 after 8 decode steps.
#: At published widths the models are chaotic in float32 (the fan-in
#: quirk: one ulp on whisper's frames moves its logits by a third of
#: their range, my CPU run), so the two paths part further with every
#: decode step they do not share; whisper's check decodes the
#: reference's 8
FORWARD_TOL = 2e-2
FORWARD_STEPS = 8
#: phase 14: the port's launch/train.py on gemma3-1b at full width and
#: depth; a checkpoint after step 3 and at the end (step 5), the end's
#: dropped (the crash), then --resume
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_FULL = ["--arch", "gemma3-1b", "--steps", "6", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every", "4",
              "--log-every", "1", "--seed", "0"]
#: the checkpoint directory (inside the checkout: build/ is git-ignored)
#: and the disk it needs: two checkpoints of 1.0 B bf16 params and two
#: float32 moments, 10 GB each
TRAIN_CKPT_DIR = os.path.join(ROOT, "build", "chip_train_ckpt")
TRAIN_DISK_GB = 25


def free_card(out):
    """Drop the serving phases' weights; the GB still allocated."""
    import gc
    import torch
    out.pop("serve_weights", None)
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def zero_launches():
    for k in _counters().values():
        k.launches = 0


def read_launches():
    return {name: k.launches for name, k in _counters().items()}


def embedding_parity():
    """Reduced whisper-small through the legacy engine and reduced
    internvl2-76b's prefill + decode on embeddings, float32, TF32 off,
    on cuda and on cpu from the same weights and inputs: whisper's
    greedy streams identical; internvl's every step's argmax identical
    and its logits within 1e-4 x max(1, max |cpu|)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import ServeEngine
    e = EMBED_REDUCED
    res = {}
    cfg = get_arch("whisper-small").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    frames = torch.randn((e["whisper_rows"], e["whisper_frames"],
                          cfg.d_model), generator=torch.Generator(
                              ).manual_seed(3))
    streams = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else tree_map(lambda t: t.to(dev), params)
        streams[dev] = ServeEngine(model, p).generate(
            {"embeds": frames.to(dev)}, e["whisper_new"]).tokens.cpu(
            ).tolist()
    check(streams["cuda"] == streams["cpu"], "reduced whisper-small: legacy "
          "engine streams differ between cuda and cpu")
    res["whisper_legacy"] = {"rows": e["whisper_rows"],
                             "frames": e["whisper_frames"],
                             "new_tokens": e["whisper_new"],
                             "streams_identical": True}
    cfg = get_arch("internvl2-76b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    n = e["internvl_prompt"] + e["internvl_decode"]
    emb = torch.randn((e["internvl_rows"], n, cfg.d_model),
                      generator=torch.Generator().manual_seed(4))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else tree_map(lambda t: t.to(dev), params)
        x = emb.to(dev)
        logits, cache = model.prefill(p, {"embeds": x[:, :e[
            "internvl_prompt"]]}, max_len=n)
        steps = [logits.cpu()]
        for i in range(e["internvl_prompt"], n):
            logits, cache = model.decode_step(p, cache, x[:, i])
            steps.append(logits.cpu())
        runs[dev] = steps
    err = 0.0
    for a, b in zip(runs["cuda"], runs["cpu"]):
        check(torch.equal(a.argmax(-1), b.argmax(-1)), "reduced "
              "internvl2-76b: argmaxes differ between cuda and cpu")
        err = max(err, float((a - b).abs().max())
                  / max(1.0, float(b.abs().max())))
    check(err <= 1e-4, f"reduced internvl2-76b: logits differ by {err} of "
          f"their range between cuda and cpu")
    res["internvl_embeddings"] = {"rows": e["internvl_rows"],
                                  "prompt": e["internvl_prompt"],
                                  "decode_steps": e["internvl_decode"],
                                  "argmax_identical": True,
                                  "max_rel_err": err}
    return res


def train_parity():
    """Three reduced gemma3-1b train steps (remat on, the system tests'
    optimizer) on cuda and on cpu from the same weights and stream:
    losses within 1e-5 relative, params within 1e-4; then the cuda run's
    params cast to bf16 with their float32 moments, checkpointed and
    restored: every leaf bit-equal, dtypes kept."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import checkpoint_tree
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.train_loop import make_train_step
    t = TRAIN_REDUCED
    cfg = get_arch("gemma3-1b").reduced()
    model = build_model(cfg)
    params0 = model.init(torch.Generator().manual_seed(0), "cpu")
    ocfg = opt.AdamWConfig(**TRAIN_OPT)
    step = make_train_step(model, ocfg, num_microbatches=1, remat=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda x: x.to(dev), params0)
        state = opt.init(ocfg, params)
        ds = SyntheticLM(cfg.vocab_size, t["batch"], t["seq"], seed=t["seed"])
        losses = []
        for _ in range(t["steps"]):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(ds).items()}
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
        runs[dev] = (params, state, losses)
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        check(abs(a - b) <= 1e-5 * max(1.0, abs(b)), f"reduced gemma3-1b "
              f"train: losses {runs['cuda'][2]} vs {runs['cpu'][2]}")
    cpu = dict(tree_leaves(runs["cpu"][0]))
    err = max(float((x.cpu() - cpu[p]).abs().max())
              for p, x in tree_leaves(runs["cuda"][0]))
    check(err <= 1e-4, f"reduced gemma3-1b train: params differ by {err} "
          f"between cuda and cpu")
    params, state, _ = runs["cuda"]
    tree = checkpoint_tree(tree_map(lambda x: x.to(torch.bfloat16), params),
                           state)
    d = os.path.join(ROOT, "build", "chip_ckpt_reduced")
    shutil.rmtree(d, ignore_errors=True)
    try:
        ck = CheckpointManager(d)
        ck.save_async(t["steps"] - 1, tree)
        ck.wait()
        back = ck.restore(ck.latest_step(), tree)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = dict(tree_leaves(back))
    for p, x in tree_leaves(tree):
        check(got[p].dtype == x.dtype and got[p].device == x.device
              and torch.equal(got[p], x), f"bf16 checkpoint: {p} changed")
    return {"train_gemma3": {"steps": t["steps"], "losses": runs["cuda"][2],
                             "max_param_err": err,
                             "bf16_checkpoint_bit_equal": True}}


def as_float32(model, params):
    """The same model and weights in float32 (the reference checks
    prefill + decode against the forward in float32)."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(model.cfg, param_dtype="float32")
    return build_model(cfg), tree_map(lambda t: t.float(), params)


def forward_gap(got, want):
    """(max |got - want|, max |want|, within the reference's atol and
    rtol FORWARD_TOL); both finite or the run fails."""
    import torch
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "logits not finite")
    gap = (got - want).abs()
    return (float(gap.max()), float(want.abs().max()),
            bool((gap <= FORWARD_TOL + FORWARD_TOL * want.abs()).all()))


def whisper_last(model, params, frames, toks):
    """The decode logits after the prefill and ``toks`` fed one at a
    time, and the teacher-forced decoder's over [BOS] + ``toks`` at the
    last position."""
    import torch
    logits, cache = model.prefill(params, {"embeds": frames})
    for i in range(toks.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, i])
    inp = torch.cat([torch.zeros_like(toks[:, :1]), toks], 1)
    full = model.decoder_logits(params, {"embeds": frames, "tokens": inp})
    return logits, full[:, -1]


def serve_whisper():
    """whisper-small at its published widths (bf16, weights from seed 0)
    through the legacy engine: ENCDEC's requests of frames, new tokens;
    tokens/s, prefill ms. Then the first FORWARD_STEPS generated tokens
    re-run by hand, prefill + decode, against the teacher-forced decoder
    over the same tokens at the last position: in bf16 (reported) and
    with the same weights in float32 (held to the reference's 2e-2)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serve.engine import ServeEngine
    e = ENCDEC
    cfg = get_arch("whisper-small")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((e["whisper_requests"], e["whisper_frames"],
                          cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             1)).to(cfg.dtype)
    eng = ServeEngine(model, params)
    eng.generate({"embeds": frames[:1]}, 2)          # warm the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, {"embeds": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = eng.generate({"embeds": frames}, e["whisper_new"]).tokens
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(toks.shape) == (e["whisper_requests"], e["whisper_new"])
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"whisper-small: generated {tuple(toks.shape)}")
    head = toks[:, :FORWARD_STEPS]
    bf16_gap, bf16_max, _ = forward_gap(*whisper_last(model, params, frames,
                                                      head))
    del eng
    model32, params32 = as_float32(model, params)
    del params
    gap, want_max, ok = forward_gap(*whisper_last(
        model32, params32, frames.float(), head))
    check(ok, f"whisper-small: float32 prefill + decode is {gap} from the "
          f"teacher-forced decoder")
    n_tok = e["whisper_requests"] * e["whisper_new"]
    return {"arch": cfg.name, "params": count_params(model.spec_tree()),
            "init_s": init_s, "requests": e["whisper_requests"],
            "frames": e["whisper_frames"], "new_tokens": e["whisper_new"],
            "wall_s": wall, "tok_per_s": n_tok / wall,
            "prefill_ms": 1e3 * prefill_s,
            "prefill_decode_vs_forward": {
                "float32_max_abs": gap, "float32_max_abs_logit": want_max,
                "bf16_max_abs": bf16_gap, "bf16_max_abs_logit": bf16_max},
            "logits_finite": True}


def internvl_last(model, params, emb, s):
    """The logits of the last decode step after a prefill on ``emb[:,
    :s]`` and one step per later embedding, and the forward over all of
    ``emb`` at its last position."""
    logits, cache = model.prefill(params, {"embeds": emb[:, :s]},
                                  max_len=emb.shape[1])
    for i in range(s, emb.shape[1]):
        logits, cache = model.decode_step(params, cache, emb[:, i])
    full, _ = model.forward(params, {"embeds": emb})
    return logits, full[:, -1]


def run_internvl():
    """internvl2-76b at its published widths cut to ENCDEC's layers
    (bf16, weights from seed 0): prefill of rows of embeddings, decode
    steps each fed the next embedding; prefill ms, tokens/s. Then the
    last step's logits against the forward over every embedding at its
    last position: in bf16 (reported) and with the same weights in
    float32 (held to the reference's 2e-2)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    e = ENCDEC
    full_cfg = get_arch("internvl2-76b")
    cfg = dataclasses.replace(full_cfg, num_layers=e["internvl_layers"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s, n = e["internvl_prompt"], e["internvl_prompt"] + e["internvl_decode"]
    emb = torch.randn((e["internvl_rows"], n, cfg.d_model), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1)
                      ).to(cfg.dtype)
    model.prefill(params, {"embeds": emb[:, :16]})   # warm the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"embeds": emb[:, :s]}, max_len=n)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()),
          "internvl2-76b: prefill logits not finite")
    t0 = time.perf_counter()
    for i in range(s, n):
        logits, cache = model.decode_step(params, cache, emb[:, i])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del logits, cache
    bf16_gap, bf16_max, _ = forward_gap(*internvl_last(model, params, emb,
                                                       s))
    model32, params32 = as_float32(model, params)
    del params
    gap, want_max, ok = forward_gap(*internvl_last(model32, params32,
                                                   emb.float(), s))
    check(ok, f"internvl2-76b: float32 prefill + decode is {gap} from the "
          f"forward")
    n_params = count_params(model.spec_tree())
    whole = count_params(build_model(full_cfg).spec_tree())
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "depth_cut": (f"{full_cfg.num_layers} -> {cfg.num_layers} "
                          f"layers: {2 * whole / 1e9:.0f} GB of bf16 "
                          f"weights whole, over the card's 80 GB"),
            "params": n_params, "weights_gb": 2 * n_params / 1e9,
            "init_s": init_s, "rows": e["internvl_rows"], "prompt": s,
            "decode_steps": e["internvl_decode"],
            "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_step": 1e3 * decode_s / e["internvl_decode"],
            "tok_per_s": e["internvl_rows"] * e["internvl_decode"] / decode_s,
            "prefill_decode_vs_forward": {
                "float32_max_abs": gap, "float32_max_abs_logit": want_max,
                "bf16_max_abs": bf16_gap, "bf16_max_abs_logit": bf16_max},
            "logits_finite": True}


def phase_encdec(out):
    """whisper-small (serve_whisper) and internvl2-76b cut in depth
    (run_internvl) at published widths, one on the card at a time after
    earlier weights are freed; peak memory each. No kernel of the five
    lies on these paths (the encoder-decoder decodes contiguously, the
    legacy engine plans no admission): every launch counter reads 0
    after the phase."""
    import gc
    import torch
    before_gb = free_card(out)
    check(before_gb < 1.0, f"earlier weights still hold {before_gb:.1f} GB "
          f"of the card")
    zero_launches()
    models = {}
    for name, fn in (("whisper-small", serve_whisper),
                     ("internvl2-76b", run_internvl)):
        torch.cuda.reset_peak_memory_stats()
        rec = fn()
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        models[name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_launches()
    check(not any(launches.values()), f"encdec: a kernel launched on a path "
          f"that has none: {launches}")
    out["launches_encdec"] = launches
    return {"allocated_before_gb": before_gb, "settings": ENCDEC,
            "models": models, "launches": launches}


def phase_train(out):
    """The port's launch/train.py on gemma3-1b at full width and depth
    (TRAIN_FULL): 6 steps, a checkpoint after step 3 and at the end; the
    end's checkpoint is dropped (a crash before it committed) and the
    run resumed with --resume: it restores step 3, replays steps 4-5 of
    the stream and must land where the first run did (params and the
    float32 moments within the reference's atol 1e-5 / rtol 1e-4; the
    leaves that differ at all are counted). Losses finite, the last below
    the first; ms a step (steps 2-6 of the first run, each ending in a
    device sync), tokens/s and peak memory. No kernel of the five lies
    on this path: every launch counter reads 0."""
    import shutil
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.models.common import tree_leaves
    before_gb = free_card(out)
    check(before_gb < 1.0, f"earlier weights still hold {before_gb:.1f} GB "
          f"of the card")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    os.makedirs(TRAIN_CKPT_DIR)
    free_gb = shutil.disk_usage(TRAIN_CKPT_DIR).free / 1e9
    check(free_gb >= TRAIN_DISK_GB, f"train: {free_gb:.1f} GB free on the "
          f"checkpoint disk, want {TRAIN_DISK_GB}")
    argv = TRAIN_FULL + ["--ckpt-dir", TRAIN_CKPT_DIR]
    zero_launches()
    try:
        torch.cuda.reset_peak_memory_stats()
        first = train_cli.main(argv)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        steps_on_disk = sorted(os.listdir(TRAIN_CKPT_DIR))
        check(steps_on_disk == ["step_00000003", "step_00000005"],
              f"train: checkpoints {steps_on_disk}")
        shutil.rmtree(os.path.join(TRAIN_CKPT_DIR, "step_00000005"))
        t0 = time.perf_counter()
        again = train_cli.main(argv + ["--resume"])
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    launches = read_launches()
    losses = first["losses"]
    check(all(math.isfinite(x) for x in losses + again["losses"]),
          f"train: losses {losses} then {again['losses']}")
    check(losses[-1] < losses[0], f"train: loss went {losses[0]} -> "
          f"{losses[-1]}")
    check(again["start_step"] == 4, f"train: resumed at step "
          f"{again['start_step']}")
    diffs = {}
    for part in ("params", "m", "v"):
        a = dict(tree_leaves(first[part] if part == "params"
                             else getattr(first["state"], part)))
        b = dict(tree_leaves(again[part] if part == "params"
                             else getattr(again["state"], part)))
        n_diff, worst, ok = 0, 0.0, True
        for p, x in a.items():
            x, y = x.float(), b[p].float()
            n_diff += int((x != y).sum())
            worst = max(worst, float((x - y).abs().max()))
            ok &= bool(torch.allclose(y, x, atol=1e-5, rtol=1e-4))
        diffs[part] = {"elements_differing": n_diff, "max_abs_diff": worst}
        check(ok, f"train: resumed {part} not within atol 1e-5 / rtol 1e-4 "
              f"of the crashed run's ({n_diff} elements differ, max "
              f"{worst})")
    check(not any(launches.values()), f"train: a kernel launched on a path "
          f"that has none: {launches}")
    out["launches_train"] = launches
    steady = sorted(first["step_seconds"][1:])
    step_s = steady[len(steady) // 2]
    return {"argv": TRAIN_FULL, "losses": losses,
            "resumed_losses": again["losses"],
            "step_seconds": first["step_seconds"],
            "ms_per_step": 1e3 * step_s,
            "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "loop_tok_per_s": first["tokens_per_s"],
            "resume_s": resume_s, "peak_mem_gb": peak_gb,
            "disk_free_gb": free_gb, "resume_vs_crash": diffs,
            "launches": launches}


# ------------------------------------------------- phase 11: servebench
#: the reference CI's servebench command line (``.github/workflows/ci.yml``)
SERVEBENCH_CI = ["--smoke", "--kv-layout", "both", "--prefix-sharing",
                 "both"]
#: phase 11 (b): servebench's flags at full width. The phase runs the
#: rows it keeps through the benchmark's row functions: legacy on two
#: requests; paged lazy and eager (the reference's defaults: gather,
#: one-shot); gather vs fused (chunked, bucketed: the main path's
#: configuration, the only row through the decode kernel); interleaved
#: chunked; the open loop. Cut to keep the phase near 4 minutes: slots
#: (phase 7 serves the slot arena at full width), one-shot interleaved
#: (its wall-clock gate is reported by part (a)) and the shared-prefix,
#: cache and chaos traces (phases 8 and 9 serve them at full width).
SERVEBENCH_FULL = ["--full-width", "--requests", "16", "--capacities", "4",
                   "--prompt-len", "128", "--new-tokens", "16",
                   "--page-size", "16", "--decode-chunk", "4"]
#: runs of the fused row and of the open loop: medians and spreads
SERVEBENCH_REPEATS = 3
#: no report files: the phase's line carries the numbers
NO_FILES = ["--out", "", "--cache-out", "", "--chaos-out", "",
            "--frontend-out", ""]


def first_difference(a, b, path=""):
    """The first path at which two reports differ, or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return f"{path}: keys {sorted(set(a) ^ set(b))}"
        for k in a:
            d = first_difference(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def spread(values):
    """min, median, max and (max - min) / median of repeated runs."""
    import statistics
    med = statistics.median(values)
    return {"runs": values, "min": min(values), "median": med,
            "max": max(values),
            "spread": (max(values) - min(values)) / med if med else None}


def servebench_reduced():
    """Phase 11 (a): the twin's main at the reference CI's command line,
    reduced qwen3-14b in float32 with TF32 off, on cuda and on cpu from
    the same weights. Every count-and-stream gate passes on cuda; every
    number a clock did not measure is identical between the devices, and
    on each the watchdog trips once per stuck holder; the one wall-clock
    gate is reported, with the step waits beside it."""
    import torch
    from repro_torch.benchmarks import servebench as sb
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(get_arch("qwen3-14b").reduced())
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    rows, seconds = {}, {}
    for dev, params in (("cuda", tree_map(lambda t: t.to("cuda"), cpu)),
                        ("cpu", cpu)):
        t0 = time.perf_counter()
        rows[dev] = sb.main(SERVEBENCH_CI + ["--device", dev, *NO_FILES],
                            model=model, params=params)
        seconds[dev] = time.perf_counter() - t0
    r = rows["cuda"]
    failed = sb.ci_gates(r, r["prefix_cache"], r["frontend"], r["chaos"])
    held = [f for f in failed if not f.startswith(sb.WALL_CLOCK_STEP)]
    check(not held, f"servebench reduced on cuda: gates failed: {held}")
    diff = first_difference(sb.untimed(rows["cuda"]),
                            sb.untimed(rows["cpu"]))
    check(diff is None, f"servebench reduced: cuda and cpu differ at {diff}")
    # the watchdog's trips are a clock's count, left out above; on the
    # card's host, with nothing else running, only stuck holders trip it
    for dev, v in rows.items():
        ch = v["chaos"]["chaos"]
        stuck = ch["faults_by_kind"].get("stuck", 0)
        check(stuck > 0 and ch["watchdog_trips"] == stuck,
              f"servebench reduced on {dev}: {ch['watchdog_trips']} "
              f"watchdog trips for {stuck} stuck holders")
    ch, un = r["interleaved"]["chunked"], r["interleaved"]["unchunked"]
    return {"seconds": seconds, "gates_failed": failed,
            "wall_clock_gate": {
                "p99_wait_s_drop_vs_unchunked":
                    ch["p99_wait_s_drop_vs_unchunked"],
                "holds": not any(f.startswith(sb.WALL_CLOCK_STEP)
                                 for f in failed),
                "p99_wait_s": [ch["p99_wait_s"], un["p99_wait_s"]],
                "p99_wait_steps": [ch["p99_wait_steps"],
                                   un["p99_wait_steps"]],
                "cpu_p99_wait_s_drop": rows["cpu"]["interleaved"][
                    "chunked"]["p99_wait_s_drop_vs_unchunked"]},
            "tok_per_s": {dev: {"paged_K4": v["paged"]["4"]["tok_per_s"],
                                "slots_K4": v["slots"]["4"]["tok_per_s"]}
                          for dev, v in rows.items()},
            "watchdog_trips": {dev: v["chaos"]["chaos"]["watchdog_trips"]
                               for dev, v in rows.items()},
            "untimed_identical": True}


def check_full_row(row, what, tokens):
    """A full-width closed-loop row: every request finished with its
    tokens, FIFO grants, allocator acquires per token a finite positive
    count (paged; the bench already drained the pool leak-free)."""
    check(row["tokens"] == tokens,
          f"{what}: {row['tokens']} tokens, want {tokens}")
    check(row["fifo_ok"], f"{what}: FIFO grant order violated")
    if "lock_acquires_per_token" in row:
        lat = row["lock_acquires_per_token"]
        check(0 < lat < float("inf"), f"{what}: acquires per token {lat}")


def host_probe():
    """The host's state at a timed region's edge: live Python objects
    (what a garbage collection walks), microseconds per eager launch of
    a tiny op on the card (host dispatch, which serving rounds are bound
    by) and milliseconds per 10^6 turns of a Python loop."""
    import gc
    import torch
    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6
    t0 = time.perf_counter()
    acc = 0
    for i in range(10 ** 6):
        acc += i
    return {"gc_objects": len(gc.get_objects()), "launch_us": launch_us,
            "python_loop_ms": (time.perf_counter() - t0) * 1e3}


def servebench_full(out):
    """Phase 11 (b): servebench's rows at full width (bf16, weights drawn
    on the card from seed 0) through its row functions on the parsed
    SERVEBENCH_FULL: legacy on 2 requests, paged lazy and eager once,
    gather once, the fused row SERVEBENCH_REPEATS times, interleaved
    chunked once, the open loop SERVEBENCH_REPEATS times (its
    closed-loop reference streams drawn once). Medians and spreads; the
    launch counters of both serving kernels zeroed before and read after
    all of it; the host's state before and after."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import servebench as sb
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve.scheduler import plan_admission
    cfg = get_arch("qwen3-14b")
    if "serve_weights" in out:
        model, params = out["serve_weights"][:2]
    else:
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    args = sb.parser().parse_args(SERVEBENCH_FULL + ["--device", "cuda"])
    k, n, new = max(args.capacities), args.requests, args.new_tokens
    prompts, arrivals = sb.closed_loop_trace(
        args.seed, n, args.prompt_len, cfg.vocab_size, args.capacities,
        new, args.load)
    run = dict(capacity=k, new_tokens=new, decode_chunk=args.decode_chunk,
               seed=args.seed, kv_layout="paged", page_size=args.page_size,
               device="cuda")
    probe_before = host_probe()
    counters = _counters()
    for name in ("paged_decode", "semaphore_admission"):
        counters[name].launches = 0
    t0 = time.perf_counter()
    legacy = sb.bench_legacy(model, params, prompts[:2], new_tokens=new,
                             device="cuda")
    check(legacy["tokens"] == 2 * new,
          f"full width legacy: {legacy['tokens']} tokens")
    plan = plan_admission(arrivals[k].astype(np.float32),
                          np.full(n, float(new), np.float32), k,
                          device="cuda")
    paged, paged_streams = sb.bench_slot_engine(
        model, params, prompts, arrivals[k], page_growth="lazy", **run)
    eager, eager_streams = sb.bench_slot_engine(
        model, params, prompts, arrivals[k], page_growth="eager", **run)
    check_full_row(paged, "full width paged lazy", n * new)
    check_full_row(eager, "full width paged eager", n * new)
    gather, gather_streams = sb.fused_run(model, params, prompts, args,
                                          "gather", device="cuda")
    check_full_row(gather, "full width gather", n * new)
    fused, fused_shares = [], []
    for i in range(SERVEBENCH_REPEATS):
        row, streams = sb.fused_run(model, params, prompts, args, "fused",
                                    device="cuda")
        check_full_row(row, f"full width fused run {i}", n * new)
        fused.append(row)
        fused_shares.append(sb.streams_match(streams, gather_streams,
                                             exact=False))
    trace = sb.interleaved_trace(args, cfg.vocab_size)
    inter, _ = sb.interleaved_run(model, params, args, trace, "chunked",
                                  device="cuda")
    check_full_row(inter, "full width interleaved chunked",
                   n * trace["new_tokens"])
    rows_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    opens, closed = [], None
    for _ in range(SERVEBENCH_REPEATS):
        fe, closed = sb.open_loop_row(model, params, args, cfg.vocab_size,
                                      closed_streams=closed, device="cuda",
                                      exact=False)
        opens.append(fe)
    open_s = time.perf_counter() - t1
    launches = {name: counters[name].launches
                for name in ("paged_decode", "semaphore_admission")}
    probe_after = host_probe()
    check(launches["paged_decode"] > 0 and launches["semaphore_admission"]
          > 0, f"servebench full width: launches {launches}")
    # only the fused rows decode through the kernel: one launch per layer
    # of each of their decode steps
    check(launches["paged_decode"] % attention_layers(cfg) == 0,
          f"servebench full width: {launches['paged_decode']} decode "
          f"launches, not a multiple of {attention_layers(cfg)} attention "
          f"layers")
    for key in ("lock_acquires_per_token", "p50_wait_steps",
                "p99_wait_steps", "decode_dispatches"):
        check(len({r[key] for r in fused}) == 1,
              f"full width fused repeats: {key} differs: "
              f"{[r[key] for r in fused]}")
    for i, fe in enumerate(opens):
        accounted = (fe["finished"] + fe["cancelled"] + fe["expired"]
                     + fe["shed"])
        check(accounted == n and fe["leaked_pages"] == 0 and fe["fifo_ok"],
              f"full width open loop run {i}: accounted {accounted} of {n},"
              f" leaked {fe['leaked_pages']}, fifo {fe['fifo_ok']}")
    out["launches_servebench"] = launches
    first = fused[0]
    return {
        "settings": " ".join(SERVEBENCH_FULL), "rows_s": rows_s,
        "open_loop_s": open_s, "launches": launches,
        "host_probe": {"before": probe_before, "after": probe_after},
        "legacy": legacy,
        "fused_K4": {
            "tok_per_s": spread([r["tok_per_s"] for r in fused]),
            "p50_wait_s": spread([r["p50_wait_s"] for r in fused]),
            "p99_wait_s": spread([r["p99_wait_s"] for r in fused]),
            "p50_wait_steps": first["p50_wait_steps"],
            "p99_wait_steps": first["p99_wait_steps"],
            "lock_acquires_per_token": first["lock_acquires_per_token"],
            "decode_dispatches": first["decode_dispatches"],
            "dispatch_trace_keys": first["dispatch_trace_keys"],
            "prefill_chunks": first["prefill_chunks"],
            "tokens_match_gather": fused_shares},
        "paged_K4": {
            "tok_per_s": paged["tok_per_s"],
            "p50_wait_s": paged["p50_wait_s"],
            "p99_wait_s": paged["p99_wait_s"],
            "p50_wait_steps": paged["p50_wait_steps"],
            "p99_wait_steps": paged["p99_wait_steps"],
            "plan_p50_wait_steps": plan.p50_wait,
            "plan_p99_wait_steps": plan.p99_wait,
            "lock_acquires_per_token": paged["lock_acquires_per_token"],
            "lock_drop_vs_eager": (eager["lock_acquires_per_token"]
                                   / paged["lock_acquires_per_token"]),
            "decode_dispatches": paged["decode_dispatches"],
            "dispatch_trace_keys": paged["dispatch_trace_keys"],
            "eager_lazy_tokens_match": sb.streams_match(
                paged_streams, eager_streams, exact=False)},
        "open_loop": {
            "ttft_p50_ms": spread([fe["ttft_p50_ms"] for fe in opens]),
            "ttft_p99_ms": spread([fe["ttft_p99_ms"] for fe in opens]),
            "tok_per_s": spread([fe["tok_per_s"] for fe in opens]),
            "goodput_tok_per_s": spread([fe["goodput_tok_per_s"]
                                         for fe in opens]),
            "closed_loop_tok_per_s": opens[0]["closed_loop_tok_per_s"],
            "cancelled": [fe["cancelled"] for fe in opens],
            "survivor_token_share": [
                fe["survivor_streams_match_closed_loop"] for fe in opens]},
        "rows_tok_per_s": {
            "paged_eager": eager["tok_per_s"],
            "gather": gather["tok_per_s"],
            "interleaved_chunked": inter["tok_per_s"]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_servebench(out):
    """The serving benchmark's twin on the card: (a) the reference CI's
    gates on the reduced model, cuda against cpu; (b) full width, the
    fused row (the main path's configuration) and the open loop
    repeated; (c) the host benchmark on the card's
    host, beside the host CPU's model. Prints each part's seconds."""
    from repro_torch.benchmarks import hostbench
    t0 = time.perf_counter()
    reduced = servebench_reduced()
    t1 = time.perf_counter()
    full = servebench_full(out)
    t2 = time.perf_counter()
    host = hostbench.main()
    t3 = time.perf_counter()
    return {"card": out.get("card"), "host_cpu": hostbench.cpu_model(),
            "part_seconds": {"reduced": t1 - t0, "full_width": t2 - t1,
                             "hostbench": t3 - t2},
            "reduced": reduced, "full_width": full, "hostbench": host}


def phase_profile(out):
    """Where the time goes at full width (run on request: ``--phases
    1,5``): the phase-4 workload; after ``warm_rounds``, ``rounds``
    scheduler rounds timed on the host clock, then ``rounds`` more under
    ``torch.profiler``. Reports device time by kernel (top 12), the
    paged-decode kernel's share, both wall times, and the idle share
    1 - busy / unprofiled wall (the rounds of both windows are
    decode-only at this point of the workload). ``--profile-layout
    slots`` profiles phase 7's engine instead (the slot arena, one-shot
    prefill, decode chunk 2): 1 warm round, then 3 and 3 rounds of
    two decode steps each, inside the first wave's decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("qwen3-14b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    c = SERVE
    layout = out.get("profile_layout", "paged")
    if layout == "slots":
        eng = make_engine(model, params, c, "cuda",
                          **dict(SLOTS, decode_chunk=2))
        warm_rounds, rounds = 1, 3
    else:
        eng = make_engine(model, params, c, "cuda")
        warm_rounds, rounds = 4, 6
    for p in make_requests(2, c, cfg.vocab_size):
        eng.submit(p, c["new_tokens"])
    for _ in range(warm_rounds):
        eng.step()
    torch.cuda.synchronize()
    # the same number of rounds without the profiler: its host-side cost
    # would otherwise inflate the wall time and the idle share
    chunks_plain = eng.prefill_chunks
    t0 = time.perf_counter()
    for _ in range(rounds):
        eng.step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    chunks_plain = eng.prefill_chunks - chunks_plain
    steps0, chunks0 = eng.decode_steps_run, eng.prefill_chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    window_steps = eng.decode_steps_run - steps0
    window_chunks = eng.prefill_chunks - chunks0
    eng.run_until_done()
    by_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    decode_ms = sum(v for k, v in by_kernel.items()
                    if any(n in k for n in DECODE_KERNELS))
    return {"layout": layout, "rounds": rounds,
            "decode_steps": window_steps,
            "prefill_chunks": window_chunks,
            "prefill_chunks_unprofiled": chunks_plain,
            "wall_ms_unprofiled": plain_wall_ms,
            "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms if by_kernel else None,
            "idle_share": (1.0 - busy_ms / plain_wall_ms) if by_kernel
            else None,
            "paged_decode_ms": decode_ms,
            "paged_decode_share_of_busy": (decode_ms / busy_ms
                                           if busy_ms else None),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_primitives(out):
    """The sync library's plan path and the kernel benchmarks on the
    card. Every launch counter is zeroed just before the path and read
    just after; the lock, barrier and membench kernels must each have
    launched."""
    import numpy as np
    from repro_torch.benchmarks import kernelbench, primitives
    from repro_torch.core.abstraction import FERMI
    from repro_torch.kernels import membench as mb
    from repro_torch.kernels import ticket_lock as tl
    from repro_torch.sync import SyncLibrary
    gpu = SyncLibrary(machine=FERMI)
    check(gpu.backend_name() == "cuda",
          f"a GPU machine abstraction resolved to backend "
          f"{gpu.backend_name()!r}, not 'cuda'")
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    n = 12
    # ---- plan_mutex: cuda against ref (bit-equal) and host (observed)
    arrival = rng.permutation(n).astype(np.int32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    mp = {be: gpu.plan_mutex(arrival, m, b, backend=be)
          for be in ("cuda", "ref", "host")}
    for be, plan in mp.items():
        check(plan.fifo and np.array_equal(plan.turn_trace, np.arange(n))
              and np.array_equal(plan.grant_order, mp["ref"].grant_order),
              f"plan_mutex[{be}]: not the FIFO timeline")
    check(mp["cuda"].backend == "cuda" and np.float32(mp["cuda"].acc)
          .view(np.int32) == np.float32(mp["ref"].acc).view(np.int32),
          "plan_mutex: cuda chain not bit-equal to ref")
    check(abs(mp["host"].acc - mp["ref"].acc)
          <= 1e-4 + 2e-4 * abs(mp["ref"].acc), "plan_mutex: host chain")
    # ---- plan_mutex_bounded: the capacity-1 fixed point (semaphore
    # kernel on cuda) against the numpy oracle and the other backends
    arrivals = np.sort(rng.uniform(0, 2, n)).astype(np.float32)
    holds = rng.uniform(0.5, 1.5, n).astype(np.float32)
    timeouts = rng.choice([0.0, 0.7, 2.5, np.inf], size=n).astype(
        np.float32)
    granted, _, _ = tl.ticket_lock_bounded_oracle(arrivals, holds,
                                                  timeouts)
    for be in ("cuda", "ref", "host"):
        plan = gpu.plan_mutex_bounded(arrivals, holds, timeouts, backend=be)
        check(np.array_equal(plan.granted, granted),
              f"plan_mutex_bounded[{be}]: granted {plan.granted} vs "
              f"oracle {granted}")
    # ---- plan_barrier: everyone, stragglers, rank 0 absent
    ones = np.ones(n, np.int64)
    no0 = ones.copy()
    no0[0] = 0
    strag = ones.copy()
    strag[[3, 7]] = 0
    for name, present, required, backends in (
            ("all", ones, ones, ("cuda", "ref", "host")),
            ("stragglers", strag, ones, ("cuda", "ref", "host")),
            ("rank0_absent", no0, no0, ("cuda", "ref", "host")),
            ("rank0_absent_required", no0, ones, ("cuda", "ref"))):
        before = counters["xf_barrier"].launches
        bp = {be: gpu.plan_barrier(present, required, backend=be)
              for be in backends}
        made = counters["xf_barrier"].launches - before
        check(made == 1, f"plan_barrier {name}: {made} barrier launches "
              f"for one cuda plan, want 1")
        for be, plan in bp.items():
            check(plan.done == bp["ref"].done
                  and np.array_equal(plan.straggler_ranks,
                                     bp["ref"].straggler_ranks)
                  and np.array_equal(plan.released, bp["ref"].released),
                  f"plan_barrier[{be}] {name}: differs from ref")
        check(bp["ref"].done == int(np.all(present[required > 0])),
              f"plan_barrier {name}: wrong done bit")
    # ---- the batched page ledger under the ticket lock
    counts = rng.integers(0, 9, n)
    on_card = tl.ticket_lock_batch_window(arrival, counts)
    on_cpu = tl.ticket_lock_batch_window(arrival, counts, device="cpu")
    check(all(np.array_equal(x, y) for x, y in zip(on_card[:2], on_cpu[:2]))
          and on_card[2:] == on_cpu[2:],
          "ticket_lock_batch_window: cuda and cpu ledgers differ")
    # ---- the kernel benchmark records and the membench cells
    recs = kernelbench.records("cuda")
    bad = [r["name"] for r in recs if not r["match"]]
    check(not bad, f"kernelbench: no match in {bad}")
    cells = {}
    for cont in (True, False):
        for wr in (True, False):
            tag = f"{'c' if cont else 'n'}{'w' if wr else 'r'}"
            cells[tag] = mb.time_cell(contentious=cont, write=wr,
                                      **MEMBENCH_CELL)
    rows, latency = primitives.smoke("cuda")
    launches = {name: k.launches for name, k in counters.items()}
    wall_s = time.perf_counter() - t0
    for name in ("ticket_lock", "xf_barrier", "membench"):
        check(launches[name] > 0,
              f"{name} never launched on the primitives path")
    out["launches_primitives"] = launches
    out["kernelbench"] = recs
    return {"backend": gpu.backend_name(), "wall_s": wall_s,
            "launches": launches,
            "kernelbench": [{"name": r["name"], "match": r["match"],
                             "ms": r["ms"]} for r in recs],
            "membench_ms_per_1000_accesses": cells,
            "membench_cell": MEMBENCH_CELL,
            "barrier_plan_latency_us": latency["backends_plan_latency_us"][
                "barrier"],
            "plan_latency_us": latency, "table5": rows[-2]}


def phase_paper(out):
    """The paper's simulators and table benchmarks through the port's
    entry points, on the card's machine: ``membench.main()`` (Tables 1-3
    simulated, the host row measured), Table 5, the Section-7 headlines
    (their strings must be the JAX package's, PAPER_HEADLINES), Figures
    1-3 on PAPER_SWEEP's block lists (no violation, every FA mutex row
    FIFO-fair), the plan latencies on host, cuda and ref, the alloc sweep
    at the reference's defaults (``pool.check()`` inside), the
    ``sync_primitives`` twin on cuda (every backend ``== ref``,
    ``plan_admission`` on cuda) and the quickstart's 10 training steps
    (losses finite; the first batch, scored again after the 10 steps,
    lower than at step 0: each step draws a new batch of uniform random
    tokens, whose loss moves from batch to batch by more than ten steps
    of training move it). Every launch counter is
    zeroed just before the phase and read just after; the semaphore,
    lock and barrier kernels must each have launched."""
    import contextlib
    import io
    import tempfile
    from repro_torch.benchmarks import membench, primitives
    from repro_torch.core.abstraction import FERMI, TESLA
    from repro_torch.examples import quickstart, sync_primitives
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        res = fn()
        secs[name] = time.perf_counter() - t
        return res

    zero_launches()
    t0 = time.perf_counter()
    rows = timed("membench", membench.main)
    names = [r.split(",")[0] for r in rows]
    check(len(rows) == 24 + 2 + 1 and names[-1] == "membench_host_classify",
          f"membench: rows {names}")
    host = dict(kv.split("=") for kv in rows[-1].split(",")[2].split(";"))
    check(all(math.isfinite(float(v)) for v in host.values()),
          f"membench: host row {rows[-1]}")
    t5 = timed("table5", primitives.table5_check)
    check(t5[0].split(",")[2].startswith("match=8/8"), f"table5: {t5[0]}")
    heads = timed("headlines", primitives.headline_speedups)
    got = tuple(r.split(",")[2] for r in heads)
    check(got == PAPER_HEADLINES, f"headlines {got}, the JAX package's "
          f"{PAPER_HEADLINES}")
    sweep = timed("sweep", lambda: primitives.sweep(
        TESLA, "tesla", PAPER_SWEEP["tesla"]) + primitives.sweep(
        FERMI, "fermi", PAPER_SWEEP["fermi"]))
    for r in sweep:
        name, _, derived = r.split(",", 2)
        check("viol=" not in derived or "viol=0" in derived,
              f"sweep: {r}")
        check("_mutex_fa_" not in name or "fair=1" in derived,
              f"sweep: {r}")
    _, latency = timed("plan_latency", lambda: primitives.
                       backend_latency_rows(backends=("host", "cuda",
                                                      "ref")))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "BENCH_alloc.json")
        alloc_rows = timed("alloc_sweep",
                           lambda: primitives.alloc_sweep(path))
        with open(path) as f:
            alloc = json.load(f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        demo = timed("sync_primitives",
                     lambda: sync_primitives.main(["--device", "cuda"]))
    text = buf.getvalue()
    plans = [ln for ln in text.splitlines()
             if ln.strip().startswith("semaphore[")]
    check(len(plans) == 3 and all(ln.endswith("== ref") for ln in plans),
          f"sync_primitives: {plans}")
    check(demo["admission"].backend == "cuda", f"sync_primitives: "
          f"plan_admission on {demo['admission'].backend!r}, not 'cuda'")
    check(demo["barrier"] is not None and demo["barrier"].stragglers == [3],
          f"sync_primitives: straggler detection {demo['barrier']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qs = timed("quickstart",
                   lambda: quickstart.main(["--device", "cuda"]))
    losses = qs["losses"]
    check(len(losses) == 10 and all(math.isfinite(x) for x in losses),
          f"quickstart: losses {losses}")
    before, after = qs["first_batch_loss"]
    check(math.isfinite(after) and after < before,
          f"quickstart: the first batch's loss went {before} -> {after} "
          f"over the 10 steps")
    launches = read_launches()
    wall_s = time.perf_counter() - t0
    for name in ("semaphore_admission", "ticket_lock", "xf_barrier"):
        check(launches[name] > 0, f"{name} never launched on the paper path")
    out["launches_paper"] = launches
    steady = sorted(qs["step_ms"][1:])
    return {"wall_s": wall_s, "seconds_by_part": secs, "launches": launches,
            "host_row": rows[-1], "host_p": host,
            "membench_ratios": [r for r in rows if "_ratios_" in r],
            "table5": t5[0].split(",", 2)[2], "headlines": list(got),
            "sweep_rows": len(sweep), "sweep_blocks": PAPER_SWEEP,
            "plan_latency_us": latency, "alloc_rows": alloc_rows[:-1],
            "alloc": alloc["arms"],
            "sync_primitives": {"plans": plans,
                                "admission_backend":
                                    demo["admission"].backend,
                                "host_machine": demo["host_lib"].machine
                                .summary(),
                                "figure2": demo["figure2"]},
            "quickstart": {"losses": losses, "step_ms": qs["step_ms"],
                           "first_batch_loss": [before, after],
                           "last_step_below_first": losses[-1] < losses[0],
                           "ms_a_step_median_2_10":
                               steady[len(steady) // 2]}}


# ------------------------------------------------------- phase 16: mesh
#: Phase 16's settings: the production mesh's tensor-parallel degree on
#: one card (the activation policy of a (1, 16) MeshShape: qwen3-14b's
#: 40 heads pad to 48, gemma3-1b's 4 take the 'seq' plan), the one-shot
#: prefill gate of 16a (two prompts of 512 tokens, numpy seed 16; max
#: |logit - tp-1 logit| within MESH_PREFILL_BOUND x max |tp-1 logit|,
#: bf16), 16b's forward (2 x 1024 tokens, numpy seed 17, float32, within
#: MESH_SEQ_TOL x max(1, max |tp-1 logit|)), the reduced twin's degree,
#: and the collectives' sizes and repeats.
MESH_TP = 16
MESH_REDUCED_TP = 3
MESH_PREFILL = dict(prompts=2, tokens=512, seed=16)
MESH_PREFILL_BOUND = 3e-2
MESH_SEQ = dict(batch=2, tokens=1024, seed=17)
MESH_SEQ_TOL = 1e-4
MESH_BYTES = (64 * 2 ** 10, 64 * 2 ** 20)
MESH_REPEATS = 20
MESH_WORLD = 4
MESH_INT8_SEED = 18


def mesh_policy(tp, batch_axes=()):
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.sharding.act import activation_sharding
    return activation_sharding(mesh_shape({"data": 1, "model": tp}),
                               batch_axes)


def pad_head_params(model, params, gen):
    """``params`` with every attention layer's ``wq`` / ``bq`` / ``wo``
    padded to the active policy's head count (the spec tree built under
    it): the padded rows of ``wq`` and ``wo`` drawn from ``gen`` at the
    init's std (``wo``'s are masked at apply time), ``bq``'s zero.
    Every other leaf is ``params``' own tensor, not a copy."""
    import math
    import torch
    from repro_torch.models.bridge import check_matches
    from repro_torch.models.common import tree_leaves

    specs = dict(tree_leaves(model.spec_tree()))
    axis = {"wq": -2, "bq": -2, "wo": -3}

    def pad(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = pad(v, path + "/")
                continue
            want = specs[path].shape
            if k not in axis or tuple(v.shape) == want:
                out[k] = v
                continue
            shape = list(v.shape)
            shape[axis[k]] = want[axis[k]] - v.shape[axis[k]]
            if specs[path].init == "zeros":
                extra = torch.zeros(shape, dtype=v.dtype, device=v.device)
            else:
                std = 1.0 / math.sqrt(max(want[0], 1))
                extra = (torch.randn(shape, generator=gen,
                                     dtype=torch.float32, device=v.device)
                         * std).to(v.dtype)
            out[k] = torch.cat([v, extra], dim=axis[k])
        return out

    padded = pad(params)
    check_matches(model, padded)
    return padded


def pad_reduced_twin():
    """16a's exact gate: reduced qwen3-14b in float32 under tp 3 (4 heads
    stored as 6), the main path's engine on cuda (the kernels) and on cpu
    (their plain versions) with the same weights: streams, grant logs
    and acquires identical."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.attention import head_plan
    from repro_torch.models.common import tree_map
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg)
    c = REDUCED
    prompts = make_requests(1, c, cfg.vocab_size)
    runs = {}
    with mesh_policy(MESH_REDUCED_TP):
        check(head_plan(cfg.num_heads) == ("pad", 6),
              f"reduced twin: head plan {head_plan(cfg.num_heads)}")
        params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        check(params_cpu["periods"]["layer_0"]["mixer"]["wq"].shape[-2] == 6,
              "reduced twin: wq not padded to 6 heads")
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = make_engine(model, params, c, dev)
            reqs, _ = serve(eng, prompts, c["new_tokens"])
            check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                          f"mesh reduced twin {dev}")
            runs[dev] = ({r.rid: r.out_tokens for r in reqs}, eng.grant_log,
                         eng.stats()["lock_acquires"])
    check(runs["cuda"][0] == runs["cpu"][0],
          "mesh reduced twin: greedy streams differ between cuda and cpu")
    check(runs["cuda"][1] == runs["cpu"][1],
          "mesh reduced twin: grant logs differ between cuda and cpu")
    check(runs["cuda"][2] == runs["cpu"][2],
          "mesh reduced twin: allocator acquire counts differ")
    return {"tp": MESH_REDUCED_TP, "heads": [cfg.num_heads, 6],
            "streams_identical": True, "grant_log": runs["cuda"][1],
            "lock_acquires": runs["cuda"][2]}


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_pad(out, cfg=None, device="cuda", tp=MESH_TP, c=SERVE,
             prefill=MESH_PREFILL):
    """16a: full-width qwen3-14b (phase 4's weights, drawn again when
    phase 4 did not run or they were freed) under the (1, 16) policy: 40
    query heads stored as 48, phase 4's 8 requests through the phase-4
    engine; the one-shot prefill gate against the tp-1 logits; the
    reduced twin. Its core also runs on the CPU at a reduced size, given
    ``cfg``, ``device="cpu"``, ``tp``, ``c`` and ``prefill``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    from repro_torch.models import build_model
    from repro_torch.models.attention import head_plan
    on_card = cfg is None
    cfg = cfg or get_arch("qwen3-14b")
    if on_card and "serve_weights" in out:
        model, params, prompts, _ = out["serve_weights"]
    else:                      # run without phase 4 or after phase 10
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
        prompts = make_requests(2, c, cfg.vocab_size)
    phase4 = out.get("phase4_streams") if on_card else None
    rng = np.random.default_rng(prefill["seed"])
    tokens = torch.tensor(rng.integers(
        0, cfg.vocab_size, (prefill["prompts"], prefill["tokens"]),
        dtype=np.int64), dtype=torch.int32, device=device)
    with torch.no_grad():
        want, _ = model.prefill(params, {"tokens": tokens},
                                max_len=prefill["tokens"])
    with mesh_policy(tp):
        plan = head_plan(cfg.num_heads)
        check(plan[0] == "pad", f"{cfg.name} at tp {tp}: plan {plan}")
        t0 = time.perf_counter()
        padded = pad_head_params(model, params, torch.Generator(
            device=device).manual_seed(MESH_TP))
        sync(device)
        pad_s = time.perf_counter() - t0
        eng = make_engine(model, padded, c, device)
        PAGED_DECODE.launches = 0
        SEMAPHORE_ADMISSION.launches = 0
        reqs, dt, queued = serve_counting(eng, prompts, c["new_tokens"])
        launches = {"paged_decode": PAGED_DECODE.launches,
                    "semaphore_admission": SEMAPHORE_ADMISSION.launches}
        decode_steps = eng.decode_steps_run
        check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                      "mesh pad plan")
        # a kernel launches on the card; the CPU runs its plain version
        on = device == "cuda"
        check(launches["paged_decode"] == on * attention_layers(cfg)
              * decode_steps and decode_steps > 0,
              f"mesh pad plan: paged_decode launched "
              f"{launches['paged_decode']} times, want "
              f"{attention_layers(cfg)} x {decode_steps}")
        check(launches["semaphore_admission"] == on * queued and queued > 0,
              f"mesh pad plan: semaphore_admission launched "
              f"{launches['semaphore_admission']} times, {queued} rounds "
              f"with a queue")
        check(eng.grant_log == list(range(c["requests"])),
              f"mesh pad plan: grant log {eng.grant_log}")
        with torch.no_grad():
            got, _ = model.prefill(padded, {"tokens": tokens},
                                   max_len=prefill["tokens"])
    out["launches_mesh"] = launches
    st = eng.stats()
    gap = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(bool(torch.isfinite(got).all()), "mesh pad plan: prefill logits "
          "not finite")
    check(gap <= MESH_PREFILL_BOUND * scale,
          f"mesh pad plan: prefill logits {gap} from tp 1, bound "
          f"{MESH_PREFILL_BOUND} x {scale}")
    same = total = 0
    if phase4 is not None:
        for r in reqs:
            total += len(r.out_tokens)
            same += sum(a == b for a, b in zip(r.out_tokens, phase4[r.rid]))
    wq_shape = list(padded["periods"]["layer_0"]["mixer"]["wq"].shape)
    del padded, eng
    rec = {"arch": cfg.name, "plan": list(plan), "wq_shape": wq_shape,
            "pad_s": pad_s, "wall_s": dt, "tokens": st["tokens"],
            "tok_per_s": st["tokens"] / dt,
            "decode_steps": decode_steps,
            "rounds_with_queue": queued, "launches": launches,
            "lock_acquires_per_token": st["lock_acquires_per_token"],
            "all_finished": True, "pages_leaked": 0,
            "tokens_equal_to_phase4": (same / total) if total else None,
            "prefill_gap": gap, "prefill_max_abs_tp1": scale,
            "prefill_gap_rel": gap / scale,
            "prefill_bound_rel": MESH_PREFILL_BOUND}
    if on_card:
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["reduced_twin"] = pad_reduced_twin()
    return rec


def mesh_seq(out, cfg=None, device="cuda", tp=MESH_TP, seq=MESH_SEQ):
    """16b: gemma3-1b whole in float32 under the (1, 16) policy — the
    'seq' plan: its 22 local layers through banded_attention, its 4
    global ones through kv_chunked_attention — on 2 x 1024 tokens, past
    the 512 window, against the tp-1 forward (blocked_attention) on the
    same weights. Its core also runs on the CPU at a reduced size, given
    ``cfg``, ``device="cpu"``, ``tp`` and ``seq``."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    out.pop("serve_weights", None)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg or get_arch("gemma3-1b"),
                              param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    rng = np.random.default_rng(seq["seed"])
    tokens = torch.tensor(rng.integers(
        0, cfg.vocab_size, (seq["batch"], seq["tokens"]),
        dtype=np.int64), dtype=torch.int32, device=device)
    calls = {}
    names = ("banded_attention", "kv_chunked_attention", "blocked_attention")
    real = {n: getattr(attn, n) for n in names}

    def counting(name):
        def run(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*a, **kw)
        return run

    for n in names:
        setattr(attn, n, counting(n))
    try:
        with torch.no_grad():
            with mesh_policy(tp):
                plan = attn.head_plan(cfg.num_heads)
                sync(device)
                t0 = time.perf_counter()
                got, _ = model.forward(params, {"tokens": tokens})
                sync(device)
                seq_s = time.perf_counter() - t0
            seq_calls = dict(calls)
            calls.clear()
            t0 = time.perf_counter()
            want, _ = model.forward(params, {"tokens": tokens})
            sync(device)
            shard_s = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(attn, n, real[n])
    check(plan == ("seq", cfg.num_heads), f"{cfg.name} at tp {tp}: plan "
          f"{plan}")
    n_local = sum(k == "local" for k in cfg.layer_kinds())
    check(seq_calls == {"banded_attention": n_local,
                        "kv_chunked_attention": cfg.num_layers - n_local},
          f"seq plan paths: {seq_calls}, {n_local} local layers")
    check(calls == {"blocked_attention": cfg.num_layers},
          f"tp-1 paths: {calls}")
    check(bool(torch.isfinite(got).all()), "seq plan: logits not finite")
    gap = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    check(gap <= MESH_SEQ_TOL * scale,
          f"seq plan: forward {gap} from tp 1, bound {MESH_SEQ_TOL} x "
          f"{scale}")
    del got, want, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"arch": cfg.name, "dtype": "float32", "plan": list(plan),
            "tokens": [seq["batch"], seq["tokens"]],
            "window": cfg.sliding_window, "paths": seq_calls,
            "max_abs_err": gap, "scale": scale,
            "err_rel": gap / scale, "tol_rel": MESH_SEQ_TOL,
            "seq_forward_s": seq_s, "shard_forward_s": shard_s}


def int8_plain(shards):
    """The compressed all-reduce in plain torch from every rank's shard,
    in rank order: each piece's dequantized contributions summed in
    float32, requantized, dequantized — the whole reduced vector."""
    import torch
    from repro_torch.train.compression import dequantize_int8, quantize_int8
    n = len(shards)
    qs = [quantize_int8(s) for s in shards]
    pieces = []
    for j in range(n):
        part = [q.reshape(n, -1)[j].to(torch.float32) * s for q, s in qs]
        summed = torch.sum(torch.stack(part), dim=0)
        pieces.append(dequantize_int8(*quantize_int8(summed)))
    return torch.cat(pieces)


def collective_times(mesh, mesh3, device, sync):
    """Median ms of each collective at MESH_BYTES (float32 vectors):
    the barrier's one-element token, the hierarchical all-reduce (data
    only, and data then pod on ``mesh3``), the int8 all-reduce, and one
    ``all_reduce`` call for the same sum (the library yardstick)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.device_barrier import (
        global_device_barrier, make_hierarchical_allreduce)
    from repro_torch.train.compression import compressed_allreduce_int8
    n = mesh.shape[0]
    bar = global_device_barrier(mesh)
    tok = torch.ones((), device=device)
    rec = {"barrier": host_ms(lambda: bar(tok), MESH_REPEATS, sync)}
    hier = make_hierarchical_allreduce(mesh)
    hier3 = make_hierarchical_allreduce(mesh3, inter_axis="pod")
    group = mesh.get_group("data")
    for nbytes in MESH_BYTES:
        v = torch.ones(nbytes // 4 // n * n, device=device)
        key = (f"{nbytes >> 20}MiB" if nbytes >= 2 ** 20
               else f"{nbytes >> 10}KiB")
        rec[key] = {
            "hierarchical": host_ms(lambda: hier(v), MESH_REPEATS,
                                           sync),
            "hierarchical_pod": host_ms(lambda: hier3(v),
                                               MESH_REPEATS, sync),
            "int8": host_ms(
                lambda: compressed_allreduce_int8(v, mesh, "data"),
                MESH_REPEATS, sync),
            "all_reduce": host_ms(
                lambda: dist.all_reduce(v.clone(), group=group),
                MESH_REPEATS, sync)}
    return rec


def mesh_checks(mesh, mesh3, device):
    """The three collectives on ``mesh`` (and the hierarchical one with a
    pod axis on ``mesh3``) against their plain sums: each rank's values,
    and whether they held."""
    import numpy as np
    import torch
    from repro_torch.core.device_barrier import (
        global_device_barrier, make_hierarchical_allreduce)
    from repro_torch.train.compression import compressed_allreduce_int8
    n = mesh.shape[0]
    ranks3 = int(np.prod(mesh3.shape))
    tok = float(global_device_barrier(mesh)(torch.ones((), device=device)))
    tok3 = float(global_device_barrier(mesh3)(torch.ones((), device=device)))
    rng = np.random.default_rng(MESH_INT8_SEED)
    v = torch.tensor(rng.standard_normal(4096), dtype=torch.float32,
                     device=device)
    hier = make_hierarchical_allreduce(mesh)(v)
    hier3 = make_hierarchical_allreduce(mesh3, inter_axis="pod")(v)
    pod = mesh3.shape[0] * mesh3.shape[1]
    shards = torch.tensor(rng.standard_normal((n, 4096)),
                          dtype=torch.float32, device=device)
    d = mesh.get_coordinate()[0]
    got = compressed_allreduce_int8(shards[d].clone(), mesh, "data")
    want = int8_plain(list(shards))
    exact = shards.sum(0)
    return {"barrier": tok, "barrier_pod": tok3,
            "barrier_ok": tok == mesh.size() and tok3 == ranks3,
            "hierarchical_ok": bool(torch.equal(hier, v * n)),
            "hierarchical_pod_ok": bool(torch.equal(hier3, v * pod)),
            "int8_bit_equal_plain": bool(torch.equal(got, want)),
            "int8_max_err_vs_exact": float((got - exact).abs().max()),
            "int8_exact_scale": float(exact.abs().max())}


def mesh_gloo_rank(rank, world):
    """One rank of 16c's gloo world on the card host (CPU tensors)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"))
    mesh3b = make_mesh((2, 2, 1), ("pod", "data", "model"))
    rec = {"checks": mesh_checks(mesh, mesh3, "cpu"),
           "checks_pod_data": mesh_checks(mesh, mesh3b, "cpu")}
    rec["times_ms"] = collective_times(mesh, mesh3b, "cpu", lambda: None)
    return rec


def mesh_collectives(out):
    """16c: an NCCL world of 1 on the card (meshes (1, 1) and (1, 1, 1)),
    then a gloo world of 4 ranks on the card host's CPU (meshes (2, 2),
    (2, 1, 2) and (2, 2, 1)): the barrier's token, the hierarchical
    all-reduce and the int8 all-reduce against their plain sums, and each
    collective's median wall time at 64 KiB and 64 MiB."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import free_port, make_mesh, run_world
    from repro_torch.train.compression import (compressed_allreduce_int8,
                                               dequantize_int8, quantize_int8)
    check(dist.is_nccl_available(), "this torch has no NCCL")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        nccl = mesh_checks(mesh, mesh3, "cuda")
        v = torch.randn(1 << 20, generator=torch.Generator(
            device="cuda").manual_seed(MESH_INT8_SEED), device="cuda")
        rt = compressed_allreduce_int8(v, mesh, "data")
        nccl["int8_round_trip_bit_equal"] = bool(torch.equal(
            rt, dequantize_int8(*quantize_int8(v))))
        nccl["times_ms"] = collective_times(mesh, mesh3, "cuda",
                                            torch.cuda.synchronize)
    finally:
        dist.destroy_process_group()
    check(nccl["barrier"] == 1.0 and nccl["barrier_ok"],
          f"nccl world of 1: barrier token {nccl['barrier']}")
    check(nccl["hierarchical_ok"] and nccl["hierarchical_pod_ok"],
          "nccl world of 1: the hierarchical all-reduce is not v")
    check(nccl["int8_bit_equal_plain"] and nccl["int8_round_trip_bit_equal"],
          "nccl world of 1: the int8 all-reduce is not the round trip")
    t0 = time.perf_counter()
    ranks = run_world(mesh_gloo_rank, MESH_WORLD, "gloo", timeout=300)
    world_s = time.perf_counter() - t0
    for r, rec in enumerate(ranks):
        for key in ("checks", "checks_pod_data"):
            c = rec[key]
            check(c["barrier_ok"], f"gloo rank {r} {key}: barrier tokens "
                  f"{c['barrier']}, {c['barrier_pod']}")
            check(c["hierarchical_ok"] and c["hierarchical_pod_ok"],
                  f"gloo rank {r} {key}: hierarchical all-reduce is not "
                  f"the plain sum")
            check(c["int8_bit_equal_plain"], f"gloo rank {r} {key}: int8 "
                  f"all-reduce differs from its plain version")
            check(c["int8_max_err_vs_exact"]
                  < 0.05 * c["int8_exact_scale"] + 1e-3,
                  f"gloo rank {r}: int8 error {c['int8_max_err_vs_exact']}")
    return {"nccl_world_1": nccl, "gloo_world_4": {
        "tensors": "host CPU (gloo); one card gives NCCL a world of 1",
        "seconds": world_s, "rank0": ranks[0],
        "times_ms_max_over_ranks": {
            k: (max(r["times_ms"][k] for r in ranks) if k == "barrier"
                else {c: max(r["times_ms"][k][c] for r in ranks)
                      for c in ranks[0]["times_ms"][k]})
            for k in ranks[0]["times_ms"]}}}


def phase_mesh(out):
    """Phase 16: the 'pad' plan at full width on the main path (16a), the
    'seq' plan's forward at full width (16b), the collectives (16c)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pad = mesh_pad(out)
    t1 = time.perf_counter()
    seq = mesh_seq(out)
    t2 = time.perf_counter()
    coll = mesh_collectives(out)
    return {"card": out.get("card"), "pad": pad, "seq": seq,
            "collectives": coll,
            "seconds_by_part": {"pad": t1 - t0, "seq": t2 - t1,
                                "collectives": time.perf_counter() - t2}}


def _counters():
    from repro_torch.kernels.membench import MEMBENCH
    from repro_torch.kernels.paged_attention import PAGED_DECODE
    from repro_torch.kernels.semaphore import SEMAPHORE_ADMISSION
    from repro_torch.kernels.ticket_lock import TICKET_LOCK
    from repro_torch.kernels.xf_barrier import XF_BARRIER
    return {"paged_decode": PAGED_DECODE,
            "semaphore_admission": SEMAPHORE_ADMISSION,
            "ticket_lock": TICKET_LOCK, "xf_barrier": XF_BARRIER,
            "membench": MEMBENCH}


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return [leaf for _, leaf in tree_leaves(tree)]


KERNELS = (
    ("paged_decode", "paged_decode.cu",
     "src/repro/kernels/paged_attention/kernel.py:113", "launches"),
    ("semaphore_admission", "semaphore_admission.cu",
     "src/repro/kernels/semaphore/kernel.py:94", "launches"),
    ("ticket_lock", "ticket_lock.cu",
     "src/repro/kernels/ticket_lock/kernel.py:104", "launches_primitives"),
    ("xf_barrier", "xf_barrier.cu",
     "src/repro/kernels/xf_barrier/kernel.py:126", "launches_primitives"),
    ("membench", "membench.cu",
     "src/repro/kernels/membench/kernel.py:80", "launches_primitives"))


def kernels_line(out):
    """The per-kernel record: launches from the run of the kernel's own
    path (phase 4 serving for the serving kernels, phase 6 primitives
    for the others), every other number measured in phase 2 of this
    run. ``ms`` is a call of the wrapper between CUDA events,
    ``kernel_ms`` the kernel alone from the profiler."""
    ks = out["kernels"]
    rows = []
    for name, source, replaces, path in KERNELS:
        k = ks[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": out.get(path, {}).get(name, 0),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "kernel_ms": k["kernel_ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "shape": k["shape"],
                     "launches_by_path": {
                         p: out[key].get(name, 0) for p, key in (
                             ("serve_paged", "launches"),
                             ("serve_slots", "launches_slots"),
                             ("prefix", "launches_prefix"),
                             ("lifecycle", "launches_lifecycle"),
                             ("families", "launches_families"),
                             ("primitives", "launches_primitives"),
                             ("servebench", "launches_servebench"),
                             ("ssm", "launches_ssm"),
                             ("encdec", "launches_encdec"),
                             ("train", "launches_train"),
                             ("paper", "launches_paper"),
                             ("mesh", "launches_mesh"))
                         if key in out},
                     **{key: k[key] for key in (
                         "hd256", "jamba", "call_ms", "launch_floor_ms",
                         "past_register_capacity", "past_staging",
                         "past_shared_memory") if key in k}})
    return {"kernels": rows, "launches": out.get("launches", {}),
            "launches_slots": out.get("launches_slots", {}),
            "launches_prefix": out.get("launches_prefix", {}),
            "launches_lifecycle": out.get("launches_lifecycle", {}),
            "launches_families": out.get("launches_families", {}),
            "launches_primitives": out.get("launches_primitives", {}),
            "launches_servebench": out.get("launches_servebench", {}),
            "launches_ssm": out.get("launches_ssm", {}),
            "launches_encdec": out.get("launches_encdec", {}),
            "launches_train": out.get("launches_train", {}),
            "launches_paper": out.get("launches_paper", {}),
            "launches_mesh": out.get("launches_mesh", {}),
            "card": out.get("card")}


PHASES = {1: ("card", phase_card), 2: ("kernels", phase_kernels),
          3: ("parity", phase_parity), 4: ("serve", phase_serve),
          5: ("profile", phase_profile), 6: ("primitives", phase_primitives),
          7: ("slots", phase_slots), 8: ("prefix", phase_prefix),
          9: ("lifecycle", phase_lifecycle), 10: ("families", phase_families),
          11: ("servebench", phase_servebench), 12: ("ssm", phase_ssm),
          13: ("encdec", phase_encdec), 14: ("train", phase_train),
          15: ("paper", phase_paper), 16: ("mesh", phase_mesh)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run (default: 1-4 and "
                         "6-16; 5, the profile, runs only when named)")
    ap.add_argument("--profile-layout", default="paged",
                    choices=("paged", "slots"),
                    help="the engine phase 5 profiles: the main path "
                         "(paged) or phase 7's slot arena")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"[chip_smoke] FAIL: the port is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    out = {"profile_layout": args.profile_layout}
    start = time.perf_counter()
    try:
        for p in sorted(int(x) for x in args.phases.split(",")):
            name, fn = PHASES[p]
            t0 = time.perf_counter()
            res = fn(out)
            emit({"phase": name, "seconds": time.perf_counter() - t0,
                  **(res or {})})
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    emit({"total_seconds": time.perf_counter() - start})
    if "kernels" in out:
        emit(kernels_line(out))
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
