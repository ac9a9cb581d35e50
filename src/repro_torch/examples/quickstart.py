"""Quickstart: the paper's sync library + a tiny LM trained for a few steps
(twin of the repository's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The ten training steps run on the card (``--device cuda``, the default;
it raises without one) or on the CPU when asked.
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.abstraction import FERMI, TESLA, PrimitiveKind, select_impl
from repro_torch.core.device import resolve_device
from repro_torch.core.primitives_sim import run_primitive
from repro_torch.models import build_model, make_batch
from repro_torch.sync import SyncLibrary
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step


def sync_primitives_demo():
    print("== machine-abstraction-driven primitive selection (paper Table 5)")
    for machine in (TESLA, FERMI):
        for prim in PrimitiveKind:
            choice = select_impl(machine, prim, semaphore_initial=10)
            print(f"  {machine.name:14s} {prim.value:9s} -> "
                  f"{choice.algorithm:13s} ({choice.strategy.value}) "
                  f"on backend {choice.backend}")

    print("\n== simulated ops/sec at 64 blocks (Tesla abstraction)")
    for impl in ("spin", "fa"):
        r = run_primitive(TESLA, "mutex", impl, blocks=64, ops=10)
        print(f"  mutex/{impl:4s}: {r.ops_per_sec:12,.0f} ops/s "
              f"(atomics used: {r.atomic_ops})")

    print("\n== real host primitives (threading)")
    lib = SyncLibrary(machine=FERMI)
    m = lib.mutex()
    with m:
        print(f"  acquired a {type(m).__name__} and released it")


def tiny_training_demo(device, steps: int = 10) -> dict:
    """``steps`` AdamW steps of reduced qwen3-14b on ``device``; returns
    the losses, the milliseconds of each step (each ends when its loss
    is read back), and the first batch's loss before and after training.
    The batches are uniform random tokens, so a step's loss moves by
    more from batch to batch than training moves it in ten steps; the
    first batch, scored again at the end, shows the progress."""
    print(f"\n== {steps} training steps of a reduced qwen3 config on "
          f"{device.type}")
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    ocfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=steps)
    state = opt.init(ocfg, params)
    step = make_train_step(model, ocfg)
    shape = ShapeConfig("demo", seq_len=32, global_batch=4, mode="train")
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        batch = make_batch(cfg, shape,
                           torch.Generator(device=device).manual_seed(i))
        if i == 0:
            first = batch
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 3 == 0 or i == steps - 1:
            print(f"  step {i}: loss {losses[-1]:.4f}")
    with torch.no_grad():
        after = float(model.loss_fn(params, first)[0])
    print(f"  first batch: loss {losses[0]:.4f} before, {after:.4f} after")
    return {"losses": losses, "step_ms": step_ms,
            "first_batch_loss": (losses[0], after)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sync_primitives_demo()
    out = tiny_training_demo(device)
    print("\nquickstart done.")
    return out


if __name__ == "__main__":
    main()
