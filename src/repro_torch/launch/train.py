"""Training driver: data -> train step -> checkpoint / restart
(counterpart of ``repro.launch.train``, with every flag of the
reference's).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt [--resume]

Trains on the card (``--device cuda``, the default; ``--device cpu``
runs on the CPU). The paper-derived control plane is in the loop as in
the reference: ``ClusterCoordinator.checkpoint_fence`` (the XF barrier)
before every save, a heartbeat per step, and auto-resume from the latest
committed checkpoint with the data stream replayed from the step after
it. Weights are random, drawn on the device from ``--seed``; batches
come from the seeded, resumable ``SyntheticLM`` stream. Token models
only: the encoder-decoder and stub-frontend families are refused, as the
reference refuses them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.coordinator import ClusterCoordinator
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.train_loop import make_train_step


def checkpoint_tree(params, state: opt.AdamWState):
    """What a checkpoint holds: the reference's keys."""
    return {"params": params, "m": state.m, "v": state.v,
            "count": state.count}


def fence(coord: ClusterCoordinator) -> None:
    """Quiesce every host before a checkpoint (the XF barrier)."""
    if not coord.checkpoint_fence(0):
        raise RuntimeError("checkpoint fence timed out")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the loop. Returns ``{"params", "state", "start_step",
    "losses"`` (one float per step run), ``"seconds"`` (the loop's wall
    time, device work included), ``"step_seconds"`` (each step's host
    time, its checkpoint snapshot included; a step that logs waits for
    the device, so with ``--log-every 1`` these are device times too),
    ``"tokens_per_s"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_encdec or cfg.frontend is not None:
        raise SystemExit("train.py drives token-LM archs; use examples/ for "
                         "stub-frontend families")

    model = build_model(cfg)
    ocfg = opt.AdamWConfig(peak_lr=args.lr,
                           warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)
    step_fn = make_train_step(model, ocfg,
                              num_microbatches=args.microbatches, remat=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    state = opt.init(ocfg, params)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    coord = ClusterCoordinator(world=1, barrier_timeout_s=60)
    if ckpt and args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            tree = ckpt.restore(latest, checkpoint_tree(params, state))
            params = tree["params"]
            state = opt.AdamWState(count=tree["count"], m=tree["m"],
                                   v=tree["v"])
            start_step = latest + 1
            print(f"[train] resumed from step {latest}")

    ds = Prefetcher(SyntheticLM(cfg.vocab_size, args.batch, args.seq,
                                seed=args.seed, start_step=start_step))
    t0 = time.time()
    tokens_done = 0
    losses, marks = [], [t0]
    try:
        for step in range(start_step, args.steps):
            raw = next(ds)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in raw.items()}
            params, state, metrics = step_fn(params, state, batch)
            losses.append(metrics["loss"])
            coord.heartbeat(0, step)
            tokens_done += args.batch * args.seq
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                tps = tokens_done / max(time.time() - t0, 1e-6)
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"tok/s {tps:,.0f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                fence(coord)
                ckpt.save_async(step, checkpoint_tree(params, state))
            marks.append(time.time())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.time() - t0
        if ckpt:
            fence(coord)
            ckpt.save(args.steps - 1, checkpoint_tree(params, state))
            ckpt.wait()
    finally:
        ds.close()
    print(f"[train] done: {args.steps - start_step} steps in "
          f"{time.time() - t0:.1f}s")
    return {"params": params, "state": state, "start_step": start_step,
            "losses": [float(x) for x in losses], "seconds": seconds,
            "step_seconds": [b - a for a, b in zip(marks, marks[1:])],
            "tokens_per_s": tokens_done / max(seconds, 1e-9)}


if __name__ == "__main__":
    main()
