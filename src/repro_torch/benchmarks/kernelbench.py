"""Kernel micro-benchmarks: every CUDA kernel of the port at the JAX
package's kernelbench shapes, each held against its plain version.

Counterpart of ``benchmarks/kernelbench.py``. Each family emits one
record per cell: its shape, ``match`` (the kernel's outputs against the
plain version's on the same inputs, made from numpy seeds) and ``ms``,
the kernel's device time from CUDA events (median of a few launches
after a warm-up). On ``--device cpu`` the op *is* the plain version:
``match`` then checks it against the cell's closed-form semantics
(FIFO grant order, vacuous straggler sets, the membench final values)
and ``ms`` is ``None`` — a CPU time is not a time of the card.

    python -m repro_torch.benchmarks.kernelbench            # on cuda
    python -m repro_torch.benchmarks.kernelbench --device cpu
    python -m repro_torch.benchmarks.kernelbench --out kernels.json

It prints one JSON record per line and writes a file only when given
``--out``.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import membench as mb
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import semaphore as sem
from repro_torch.kernels import ticket_lock as tl
from repro_torch.kernels import xf_barrier as xb

Record = Dict[str, object]


def device_ms(fn: Callable[[], object], dev: torch.device,
              reps: int = 5) -> Optional[float]:
    """Median device time of ``fn`` in ms from CUDA events, after one
    warm-up call; ``None`` off the card."""
    if dev.type != "cuda":
        return None
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _same(got, want) -> bool:
    """Exact equality of tensors (bit-equal for floats)."""
    g = got.detach().cpu()
    w = want.detach().cpu()
    if g.dtype == torch.float32:
        g, w = g.view(torch.int32), w.view(torch.int32)
    return g.shape == w.shape and bool(torch.equal(g, w))


def bench_xf_barrier(dev: torch.device, n: int = 64) -> Record:
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    got = xb.xf_barrier(flags, 1, ones, ones)
    want = xb.xf_barrier_plain(flags.cpu(), 1, ones.cpu(), ones.cpu())
    ok = all(_same(g, w) for g, w in zip(got, want)) and int(got[2]) == 1
    ms = device_ms(lambda: xb.xf_barrier(flags, 1, ones, ones, check=False),
                   dev)
    xb.XF_BARRIER.check_pending()
    return {"family": "xf_barrier", "name": f"kernel_xf_barrier_n{n}",
            "n": n, "device": dev.type, "match": ok, "ms": ms}


def bench_ticket_lock(dev: torch.device, n: int = 64) -> Record:
    rng = np.random.default_rng(0)
    arr = torch.tensor(rng.permutation(n), dtype=torch.int32, device=dev)
    m = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                     device=dev)
    got = tl.ticket_lock(arr, m, b)
    want = tl.ticket_lock_plain(arr.cpu(), m.cpu(), b.cpu())
    fifo = _same(got[0], arr) and _same(
        got[1], torch.arange(n, dtype=torch.int32))
    ok = fifo and all(_same(g, w) for g, w in zip(got, want))
    ms = device_ms(lambda: tl.ticket_lock(arr, m, b, check=False), dev)
    tl.TICKET_LOCK.check_pending()
    return {"family": "ticket_lock", "name": f"kernel_ticket_lock_n{n}",
            "n": n, "device": dev.type, "match": ok, "fifo": fifo,
            "ms": ms}


def bench_semaphore(dev: torch.device, n: int = 64,
                    capacity: int = 4) -> Record:
    rng = np.random.default_rng(0)
    at = torch.tensor(np.sort(rng.uniform(0, 10, n)), dtype=torch.float32,
                      device=dev)
    hold = torch.tensor(rng.uniform(0.1, 2.0, n), dtype=torch.float32,
                        device=dev)
    got = sem.semaphore_admission(at, hold, capacity)
    want = sem.semaphore_admission_plain(at.cpu(), hold.cpu(), capacity)
    g = got[0].cpu().numpy()
    ok = (all(_same(x, y) for x, y in zip(got, want))
          and bool(np.all(np.diff(g) >= 0)))
    return {"family": "semaphore",
            "name": f"kernel_semaphore_n{n}_k{capacity}", "n": n,
            "capacity": capacity, "device": dev.type, "match": ok,
            "ms": device_ms(lambda: sem.semaphore_admission(at, hold,
                                                            capacity), dev)}


def bench_membench(dev: torch.device, n_steps: int = 16,
                   repeats: int = 8) -> List[Record]:
    out = []
    for cont in (True, False):
        for wr in (True, False):
            buf = mb.make_buffer(n_steps, device=dev)
            kw = dict(n_steps=n_steps, contentious=cont, write=wr,
                      repeats=repeats)
            bk, sk = mb.membench(buf, **kw)
            br, sr = mb.membench_plain(buf.cpu(), **kw)
            ok = _same(bk, br) and bool(torch.allclose(
                sk.cpu(), sr, rtol=1e-6, atol=0.0))
            if wr:   # the sequential grid's closed form
                ok &= _same(sk, (repeats + torch.arange(n_steps)).float()
                            * mb.LANE)
            ms = device_ms(lambda: mb.membench(buf, **kw), dev)
            tag = f"{'c' if cont else 'n'}{'w' if wr else 'r'}"
            out.append({"family": "membench",
                        "name": f"kernel_membench_{tag}",
                        "contentious": cont, "write": wr,
                        "n_steps": n_steps, "repeats": repeats,
                        "device": dev.type, "match": ok, "ms": ms})
    return out


def bench_paged_attention(dev: torch.device) -> List[Record]:
    """A GQA cell and an MHA cell, both with ragged lengths, a
    sentinel-tail table and one fully masked row."""
    out = []
    for tag, kv, g, ps in (("gqa4", 2, 4, 4), ("mha", 4, 1, 8)):
        b, hd, num_pages, p_cap = 4, 16, 24, 4
        rng = np.random.default_rng(17)

        def put(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=dev)
        q = put(rng.standard_normal((b, kv, g, hd)))
        k = put(rng.standard_normal((num_pages, ps, kv, hd)))
        v = put(rng.standard_normal((num_pages, ps, kv, hd)))
        lens = rng.integers(1, p_cap * ps + 1, size=b)
        pages = np.full((b, p_cap), num_pages, np.int32)
        for i in range(b - 1):               # last row stays fully masked
            need = -(-int(lens[i]) // ps)
            pages[i, :need] = rng.choice(num_pages, size=need,
                                         replace=False)
        pages_t = put(pages, torch.int32)
        lens_t = put(lens, torch.int32)
        got = pa.paged_decode(q, k, v, pages_t, lens_t)
        want = pa.paged_decode_plain(q.cpu(), k.cpu(), v.cpu(),
                                     pages_t.cpu(), lens_t.cpu())
        ok = bool(torch.allclose(got.cpu(), want, atol=1e-5, rtol=1e-5)) \
            and bool((got[-1] == 0).all())
        out.append({"family": "paged_attention",
                    "name": f"kernel_paged_attention_{tag}",
                    "batch": b, "kv_heads": kv, "gqa_group": g,
                    "head_dim": hd, "page_size": ps,
                    "num_pages": num_pages, "table_width": p_cap,
                    "device": dev.type, "match": ok,
                    "ms": device_ms(lambda: pa.paged_decode(
                        q, k, v, pages_t, lens_t), dev)})
    return out


def records(device=None) -> List[Record]:
    """Every family's records on ``device`` (``cuda`` unless the caller
    asks for ``cpu``)."""
    dev = resolve_device(device)
    out = [bench_xf_barrier(dev), bench_ticket_lock(dev),
           bench_semaphore(dev)]
    out += bench_membench(dev)
    out += bench_paged_attention(dev)
    return out


def main(argv=None) -> List[Record]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    recs = records(args.device)
    for r in recs:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=2)
    return recs


if __name__ == "__main__":
    main()
