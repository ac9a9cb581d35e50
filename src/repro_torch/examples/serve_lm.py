"""Slot-pool continuous batching example: N > K requests, FIFO-verified
(twin of the repository's ``examples/serve_lm.py``).

Round-trips 12 concurrent requests through a 4-slot engine: the
Algorithm-5 sleeping semaphore gates admission, the admission kernel
plans each round's batch, and one batched decode serves all active slots
per dispatch.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --kv-layout paged
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

With ``--kv-layout paged`` the engine runs on the block-table page arena
and, after the round-trip, serves at equal arena bytes one context
longer than the contiguous layout's ``max_len``, with tokens identical
to the legacy per-request loop; then two requests with the same prompt
served with prefix sharing on allocate fewer pages than with it off
(the second adopts the first's prefix pages and splits only at its first
divergent write), with identical token streams either way.
"""

import argparse

import numpy as np
import torch

from repro_torch.launch.serve import main as serve_main

DEFAULTS = ["--arch", "qwen3-14b", "--smoke", "--requests", "12",
            "--capacity", "4", "--prompt-len", "16", "--new-tokens", "8",
            "--legacy"]


def parser() -> argparse.ArgumentParser:
    # only the layout knobs (and the device) are overridable: the asserts
    # pin the fixed 12-request workload
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-layout", default="slots",
                    choices=("slots", "paged"))
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--page-growth", default="lazy",
                    choices=("lazy", "eager"))
    ap.add_argument("--prefix-sharing", default="auto",
                    choices=("auto", "on", "off"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    from repro_torch.serve.engine import ServeEngine, SlotServeEngine

    ex = parser().parse_args(argv)
    argv = DEFAULTS + ["--kv-layout", ex.kv_layout,
                       "--page-size", str(ex.page_size),
                       "--page-growth", ex.page_growth,
                       "--prefix-sharing", ex.prefix_sharing]
    if ex.device is not None:
        argv += ["--device", ex.device]
    engine = serve_main(argv)
    # N > K round-trip: every request finished, grants in arrival order
    assert len(engine.finished) == 12
    assert engine.grant_log == sorted(engine.grant_log), engine.grant_log
    assert all(len(r.out_tokens) == 8 for r in engine.finished)
    print("[example] 12 requests over 4 slots: FIFO grant order verified")
    if engine.kv_layout != "paged":
        return engine

    dev = engine.device
    engine.pool.check()                        # no page leaks after drain
    # same arena bytes as the contiguous layout (K * max_len tokens), one
    # request almost twice as long as a slot row
    max_len = engine.max_len
    long_len = 2 * max_len - 6
    prompt = np.asarray(np.random.default_rng(7).integers(1, 100, 12),
                        np.int32)
    new_tokens = long_len - prompt.size
    paged = SlotServeEngine(
        engine.model, engine.params, capacity=4, max_len=max_len,
        kv_layout="paged", page_size=ex.page_size, decode_chunk=2,
        page_growth=ex.page_growth, device=dev)
    req = paged.submit(prompt, max_new_tokens=new_tokens)
    paged.run_until_done(max_rounds=200)
    assert len(req.out_tokens) == new_tokens
    paged.pool.check()
    if ex.page_growth == "lazy":
        # the long context grew page by page: more grants than the one
        # eager reservation, one lock acquire each
        assert paged.pool.pages.allocs > 1, "lazy growth never grew"
    legacy = ServeEngine(engine.model, engine.params, max_len=long_len + 1)
    want = legacy.generate(
        {"tokens": torch.from_numpy(prompt)[None].to(dev)}, new_tokens)
    assert req.out_tokens == want.tokens[0].tolist()
    print(f"[example] paged arena served a {long_len}-token context "
          f"in a max_len={max_len} arena "
          f"(tokens match the legacy loop)")

    # copy-on-write prefix sharing: the second same-prompt request
    # arrives after the first's prefill landed, adopts its pages and
    # splits the partial one at its first write; page size 4 puts the
    # 13-token prompt on 3 full pages and a partial one
    demo_prompt = np.asarray(np.random.default_rng(11).integers(1, 100, 13),
                             np.int32)

    def run_pair(mode):
        eng = SlotServeEngine(
            engine.model, engine.params, capacity=4, max_len=max_len,
            kv_layout="paged", page_size=4, decode_chunk=2,
            page_growth=ex.page_growth, prefix_sharing=mode, device=dev)
        first = eng.submit(demo_prompt, max_new_tokens=6)
        eng.step()                           # leader inserts + decodes
        second = eng.submit(demo_prompt.copy(), max_new_tokens=6)
        eng.run_until_done(max_rounds=100)
        eng.pool.check()                     # refcounts drained cleanly
        assert eng.pool.pages.in_use == 0
        return eng, first, second

    on, on_a, on_b = run_pair("on")
    off, off_a, off_b = run_pair("off")
    assert on_a.out_tokens == off_a.out_tokens
    assert on_b.out_tokens == off_b.out_tokens
    assert on.prefix_hits >= 1 and on.shared_pages_adopted >= 1
    assert on.pool.pages.pages_alloced < off.pool.pages.pages_alloced
    print(f"[example] prefix sharing: same-prompt pair allocated "
          f"{int(on.pool.pages.pages_alloced)} pages shared vs "
          f"{int(off.pool.pages.pages_alloced)} unshared "
          f"({int(on.shared_pages_adopted)} adopted, "
          f"{int(on.cow_splits)} CoW split(s)); "
          f"token streams identical")
    return engine


if __name__ == "__main__":
    main()
