#!/usr/bin/env python3
"""Drive the PyTorch port's serving main path on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Run from the root of a checkout; it needs ``src/repro_torch`` beside it
and a CUDA card, and exits non-zero without printing a result otherwise.
It never imports ``jax`` or the JAX package. Phases, each printing one
JSON line with its seconds:

  1 card     the card's name and power limit (nvidia-smi); both CUDA
             kernels built from ``src/repro_torch/csrc`` in parallel
  2 kernels  each kernel against its plain torch version on the card,
             with its time, the plain version's time, the bound and the
             library yardstick
  3 parity   reduced qwen3-14b served on cuda (kernels) and on cpu
             (plain versions) from the same weights and requests:
             greedy streams and grant logs identical
  4 serve    full-width qwen3-14b (40 layers, bf16) serving 8 requests
             through the paged, chunked-prefill, bucketed engine; launch
             counters prove both kernels carried the path
  5 profile  (only when named: ``--phases 1,5``) six decode rounds of
             the phase-4 workload timed plainly, then six more under
             torch.profiler: device time by kernel and the device's
             idle share (busy over the unprofiled wall time)

Then one JSON line naming every kernel with its launches, times and
bound, and last the device line. Every failed check exits non-zero
before the last line.
"""

from __future__ import annotations

import argparse
import json
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


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


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


def host_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    t0 = time.perf_counter()
    libs = build.build(["paged_decode.cu", "semaphore_admission.cu"])
    ptxas = {}
    for src, lib in libs.items():
        log = lib.with_name(lib.name + ".log")
        ptxas[src] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln][:6] \
            if log.is_file() else []
    out["card"] = card
    return {"card": card, "nvcc": build.nvcc(),
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


def phase_kernels(out):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import semaphore as sem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    # ---- paged_decode: the grid of the reference's differential tests
    tol_f32 = 1e-5
    worst = 0.0
    n_cases = 0
    for ps in (1, 4, 16):
        for kv, g in ((8, 1), (2, 4), (1, 8)):
            for window in (None, 5):
                q, k, v, pages, lens = decode_case(
                    ps * 10 + kv, b=4, kv=kv, g=g, hd=32, ps=ps,
                    num_pages=24, p_cap=5, dtype=torch.float32,
                    dead_row=True)
                got = pa.paged_decode(q, k, v, pages, lens, window=window)
                want = pa.paged_decode_plain(q, k, v, pages, lens,
                                             window=window)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err <= tol_f32, f"paged_decode ps={ps} kv={kv} g={g} "
                      f"window={window}: max abs err {err} > {tol_f32}")
                check(bool((got[-1] == 0).all()),
                      "paged_decode: all-sentinel row is not exact zeros")
                worst = max(worst, err)
                n_cases += 1
    # ---- full width, the shapes the main path gives the kernel
    c = SERVE
    max_len = c["prompt_max"] + c["new_tokens"] + 1
    num_pages = -(-c["capacity"] * max_len // c["page_size"])
    p_cap = min(-(-2 * max_len // c["page_size"]), num_pages)
    full = dict(b=c["capacity"], kv=8, g=5, hd=128, ps=c["page_size"],
                num_pages=num_pages, p_cap=p_cap,
                max_len=c["prompt_max"] + c["new_tokens"])
    q, k, v, pages, lens = decode_case(7, dtype=torch.float32, **full)
    err_full32 = float((pa.paged_decode(q, k, v, pages, lens)
                        - pa.paged_decode_plain(q, k, v, pages, lens))
                       .abs().max())
    check(err_full32 <= tol_f32,
          f"paged_decode full width f32: {err_full32} > {tol_f32}")
    q, k, v, pages, lens = decode_case(8, dtype=torch.bfloat16, **full)
    got = pa.paged_decode(q, k, v, pages, lens).float()
    want = pa.paged_decode_plain(q, k, v, pages, lens).float()
    # both accumulate in fp32; the last rounding to bf16 may fall either
    # side of a tie, so one bf16 ulp of the value rides on the tolerance
    tol_bf16 = 2e-3
    excess = ((got - want).abs() - tol_bf16 - want.abs() * 2.0 ** -7)
    err_bf16 = float((got - want).abs().max())
    check(float(excess.max()) <= 0.0,
          f"paged_decode full width bf16: max abs err {err_bf16} beyond "
          f"{tol_bf16} + 1 ulp")
    ms = cuda_ms(lambda: pa.paged_decode(q, k, v, pages, lens))
    plain_ms = cuda_ms(lambda: pa.paged_decode_plain(q, k, v, pages, lens))
    nbytes, ops = decode_work(q, k, pages, lens)
    bms, bby = bound_ms(nbytes, ops, "bfloat16")
    # library yardstick, never called by the port: SDPA over the gathered,
    # head-expanded view with the length mask (the gather is not timed)
    b, kvh, g, hd = q.shape
    idx = pages.long().clamp(0, num_pages - 1)
    kb = k[idx].reshape(b, -1, kvh, hd)
    vb = v[idx].reshape(b, -1, kvh, hd)
    ke = kb.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    ve = vb.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    qh = q.reshape(b, kvh * g, 1, hd)
    mask = (torch.arange(ke.shape[2], device="cuda")[None]
            < lens.long()[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, ke, ve, attn_mask=mask))
    res["paged_decode"] = {
        "cases_f32": n_cases, "max_abs_err_f32": worst,
        "max_abs_err_full_f32": err_full32, "max_abs_err": err_bf16,
        "tol_f32": tol_f32, "tol_bf16": f"{tol_bf16} + 1 bf16 ulp",
        "shape": {k_: v_ for k_, v_ in full.items()}, "dtype": "bfloat16",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "bytes": nbytes, "ops": ops, "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention on the gathered view"}

    # ---- semaphore_admission: bit-identical on seeded traces
    rng = np.random.default_rng(0)
    n_checked = 0
    for n in (64, 128):
        for cap in (1, 4, 8, 64):
            arr = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
            hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
            a_t = torch.tensor(arr, device="cuda")
            h_t = torch.tensor(hold, device="cuda")
            g1, r1, w1 = sem.semaphore_admission(a_t, h_t, cap)
            g0, r0, w0 = sem.semaphore_admission_plain(a_t.cpu(), h_t.cpu(),
                                                       cap)
            for x, y, name in ((g1, g0, "grant"), (r1, r0, "release")):
                check(np.array_equal(x.cpu().numpy().view(np.int32),
                                     y.numpy().view(np.int32)),
                      f"semaphore_admission N={n} K={cap}: {name} differs")
            check(np.array_equal(w1.cpu().numpy(), w0.numpy()),
                  f"semaphore_admission N={n} K={cap}: waited differs")
            n_checked += 1
    # main-path shape: the engine's planning window (64) at capacity 4
    n, cap = 64, c["capacity"]
    arr = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
    hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
    a_t, h_t = torch.tensor(arr, device="cuda"), torch.tensor(hold,
                                                             device="cuda")
    ms = cuda_ms(lambda: sem.semaphore_admission(a_t, h_t, cap), flush_mb=1)
    a_c, h_c = a_t.cpu(), h_t.cpu()
    t0 = time.perf_counter()
    for _ in range(20):
        sem.semaphore_admission_plain(a_c, h_c, cap)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 20
    window = sem.AdmissionWindow("cuda", base_window=64)
    call_ms = host_ms(lambda: window(arr[:40], hold[:40], capacity=cap))
    # the floor a one-warp sequential kernel really meets: one launch of
    # a one-element kernel on the same stream
    one = torch.zeros(1, device="cuda")
    launch_floor_ms = cuda_ms(lambda: one.add_(1.0), flush_mb=1)
    nbytes = 5 * n * 4
    ops = float(n * (cap + 2))
    bms, bby = bound_ms(nbytes, ops, "float32")
    res["semaphore_admission"] = {
        "traces": n_checked, "bit_identical": True, "max_abs_err": 0.0,
        "shape": {"n": n, "capacity": cap}, "ms": ms,
        "plain_ms": plain_ms, "plain_on": "host (numpy loop)",
        "call_ms": call_ms, "launch_floor_ms": launch_floor_ms,
        "bound_ms": bms, "bound_by": bby,
        "bytes": nbytes, "ops": ops, "library_ms": None}
    out["kernels"] = res
    return res


# ------------------------------------------------------ phases 3-4: serving
def make_requests(seed, c, vocab):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(
        c["prompt_min"], c["prompt_max"] + 1)), dtype=np.int32)
        for _ in range(c["requests"])]


def make_engine(model, params, c, device, **kw):
    from repro_torch.serve.engine import SlotServeEngine
    return SlotServeEngine(
        model, params, capacity=c["capacity"],
        max_len=c["prompt_max"] + c["new_tokens"] + 1,
        page_size=c["page_size"], prefill_chunk_tokens=c["prefill_chunk"],
        decode_chunk=c["decode_chunk"], attention_impl="fused",
        bucketed_dispatch="on", device=device, **kw)


def serve(engine, prompts, new_tokens):
    """Submit all, drain, synchronise. Returns (requests, wall seconds)."""
    import torch
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_done()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def check_drained(engine, reqs, new_tokens, vocab, what):
    check(all(r.state.value == "finished" and len(r.out_tokens) == new_tokens
              for r in reqs), f"{what}: a request did not finish with "
          f"{new_tokens} tokens")
    check(all(0 <= t < vocab for r in reqs for t in r.out_tokens),
          f"{what}: token id out of the vocabulary")
    check(engine.grant_log == sorted(engine.grant_log),
          f"{what}: FIFO grant order violated: {engine.grant_log}")
    try:
        engine.pool.check()
    except AssertionError as e:
        raise SmokeFailure(f"{what}: page pool inconsistent: {e}")
    check(engine.pool.pages.in_use == 0,
          f"{what}: {engine.pool.pages.in_use} pages leaked after drain")


def phase_parity(out):
    """Reduced qwen3-14b, float32, TF32 off: the engine on cuda (CUDA
    kernels) and on cpu (plain versions), same weights and requests."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    c = REDUCED
    prompts = make_requests(1, c, cfg.vocab_size)
    runs = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = make_engine(model, params, c, dev)
        reqs, dt = serve(eng, prompts, c["new_tokens"])
        check_drained(eng, reqs, c["new_tokens"], cfg.vocab_size,
                      f"reduced {dev}")
        runs[dev] = ({r.rid: r.out_tokens for r in reqs}, eng.grant_log,
                     eng.pool.pages.lock_stats()["acquires"])
    check(runs["cuda"][0] == runs["cpu"][0],
          "reduced parity: greedy streams differ between cuda and cpu")
    check(runs["cuda"][1] == runs["cpu"][1],
          "reduced parity: grant logs differ between cuda and cpu")
    check(runs["cuda"][2] == runs["cpu"][2],
          "reduced parity: allocator acquire counts differ")
    return {"requests": c["requests"], "streams_identical": True,
            "grant_log": runs["cuda"][1],
            "lock_acquires": runs["cuda"][2]}


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
          == cfg.num_layers * eng.decode_steps_run,
          f"paged_decode launched {launches['paged_decode']} times, want "
          f"{cfg.num_layers} x {eng.decode_steps_run} decode steps")
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
            "dispatch_shapes": st["dispatch_shapes"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_profile(out, warm_rounds: int = 4, rounds: int = 6):
    """Where the time goes at full width (run on request: ``--phases
    1,5``): the phase-4 workload; after ``warm_rounds``, ``rounds``
    scheduler rounds timed on the host clock, then ``rounds`` more under
    ``torch.profiler``. Reports device time by kernel (top 12), the
    paged-decode kernel's share, both wall times, and the idle share
    1 - busy / unprofiled wall (the rounds of both windows are
    decode-only at this point of the workload)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("qwen3-14b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    c = SERVE
    eng = make_engine(model, params, c, "cuda")
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
                    if "paged_decode_kernel" in k)
    return {"rounds": rounds, "decode_steps": window_steps,
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


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return [leaf for _, leaf in tree_leaves(tree)]


def kernels_line(out):
    """The per-kernel record: launches from the main-path run (phase 4),
    every other number measured in phase 2 of this run."""
    ks = out["kernels"]
    launches = out.get("launches", {})
    rows = []
    for name, source, replaces in (
            ("paged_decode", "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/paged_attention/kernel.py:113"),
            ("semaphore_admission",
             "src/repro_torch/csrc/semaphore_admission.cu",
             "src/repro/kernels/semaphore/kernel.py:94")):
        k = ks[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    return {"kernels": rows, "launches": launches, "card": out.get("card")}


PHASES = {1: ("card", phase_card), 2: ("kernels", phase_kernels),
          3: ("parity", phase_parity), 4: ("serve", phase_serve),
          5: ("profile", phase_profile)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated phases to run (default: 1-4; "
                         "5, the profile, runs only when named)")
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
    out = {}
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
    if "kernels" in out:
        emit(kernels_line(out))
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
