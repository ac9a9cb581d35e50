"""Async streaming client demo: two concurrent streams, one cancelled
(twin of the repository's ``examples/serve_stream.py``).

Two clients submit concurrently through the asyncio front-end and
consume tokens as decode rounds complete; the second hangs up after
three tokens. The cancelled request's slot and pages are reclaimed at
the next round boundary through the engine's retire path — the arena is
exactly full again after the drain — while the surviving stream is
untouched.

    PYTHONPATH=src python -m repro_torch.examples.serve_stream
    PYTHONPATH=src python -m repro_torch.examples.serve_stream --device cpu
"""

import argparse
import asyncio

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import AsyncFrontend, RequestState, SlotServeEngine

NEW_TOKENS = 12
CANCEL_AFTER = 3


async def stream(name, handle, cancel_after=None):
    got = []
    async for tok in handle:
        got.append(tok)
        print(f"[{name}] token {len(got):2d}: {tok}")
        if cancel_after is not None and len(got) >= cancel_after:
            print(f"[{name}] hanging up after {len(got)} tokens")
            handle.cancel()
    ttft = (f"TTFT {handle.ttft_s * 1e3:.0f}ms"
            if handle.ttft_s is not None else "no first token")
    print(f"[{name}] stream closed: {handle.state.value}, "
          f"{len(got)} tokens, {ttft}")
    return got


async def run(device) -> SlotServeEngine:
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 9)]
    engine = SlotServeEngine(
        model, params, capacity=2, max_len=32, decode_chunk=2, seed=0,
        kv_layout="paged", page_size=8, prefill_chunk_tokens=8,
        device=device)

    async with AsyncFrontend(engine, intake_limit=8) as fe:
        a = await fe.submit(prompts[0], NEW_TOKENS)
        b = await fe.submit(prompts[1], NEW_TOKENS)
        got_a, got_b = await asyncio.gather(
            stream("alice", a),
            stream("bob  ", b, cancel_after=CANCEL_AFTER))
        await fe.drain()

    assert a.state is RequestState.FINISHED and len(got_a) == NEW_TOKENS
    assert b.state is RequestState.CANCELLED
    assert CANCEL_AFTER <= len(got_b) < NEW_TOKENS
    engine.pool.pages.check()              # refcount/free-list invariants
    assert engine.pool.pages.n_free == engine.pool.pages.num_pages
    st = engine.stats()
    print(f"[example] {int(st['finished'])} finished, "
          f"{int(st['cancelled'])} cancelled over "
          f"{int(st['decode_dispatches'])} dispatches; page arena "
          f"exactly full again ({engine.pool.pages.n_free}/"
          f"{engine.pool.pages.num_pages} free) — cancellation freed "
          f"every page at the round boundary")
    return engine


def main(argv=None) -> SlotServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return asyncio.run(run(resolve_device(args.device)))


if __name__ == "__main__":
    main()
