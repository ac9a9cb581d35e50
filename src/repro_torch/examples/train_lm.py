"""End-to-end training driver (twin of the repository's
``examples/train_lm.py``): a small LM for a few hundred steps with async
checkpointing, a simulated crash, and auto-resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 25m
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 5m \\
        --steps 60 --crash-at 30 --device cpu       # then again with --resume

The presets are the reference's (the 100m preset is the deliverable's
target size, 25m the default, 5m a quick one), trained on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``).
"""

import argparse
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.coordinator import ClusterCoordinator
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import checkpoint_tree, fence
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.train_loop import make_train_step

PRESETS = {
    "100m": ArchConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
        layer_pattern=("attn",), param_dtype="float32"),
    "25m": ArchConfig(
        name="lm-25m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, d_ff=1536, vocab_size=16384,
        layer_pattern=("attn",), param_dtype="float32"),
    "5m": ArchConfig(
        name="lm-5m", family="dense", num_layers=4, d_model=192,
        num_heads=4, num_kv_heads=2, d_ff=768, vocab_size=4096,
        layer_pattern=("attn",), param_dtype="float32"),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="25m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_lm")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a crash after this step (then rerun "
                    "with --resume)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    """Run the example. Returns ``{"params", "state", "losses"`` (one per
    step run), ``"crashed"}``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    model = build_model(cfg)
    n = count_params(model.spec_tree())
    print(f"[train_lm] {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step")

    ocfg = opt.AdamWConfig(peak_lr=3e-4, warmup_steps=args.steps // 10,
                           total_steps=args.steps)
    step_fn = make_train_step(model, ocfg, num_microbatches=1, remat=True)
    coord = ClusterCoordinator(world=1)
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2)

    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    state = opt.init(ocfg, params)
    start = 0
    if args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            tree = ckpt.restore(latest, checkpoint_tree(params, state))
            params, state = tree["params"], opt.AdamWState(
                count=tree["count"], m=tree["m"], v=tree["v"])
            start = latest + 1
            print(f"[train_lm] resumed from step {latest}")

    ds = Prefetcher(SyntheticLM(cfg.vocab_size, args.batch, args.seq,
                                seed=0, start_step=start))
    t0 = time.time()
    losses = []
    try:
        for step in range(start, args.steps):
            raw = next(ds)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in raw.items()}
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            coord.heartbeat(0, step)
            if step % 20 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                tps = (step - start + 1) * args.batch * args.seq / max(dt,
                                                                       1e-6)
                print(f"[train_lm] step {step:4d} loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e} tok/s {tps:,.0f}")
            if (step + 1) % 50 == 0:
                fence(coord)
                ckpt.save_async(step, checkpoint_tree(params, state))
            if args.crash_at is not None and step >= args.crash_at:
                ckpt.wait()
                print(f"[train_lm] simulated crash at step {step} "
                      f"(latest checkpoint: {ckpt.latest_step()}); rerun "
                      f"with --resume")
                return {"params": params, "state": state, "losses": losses,
                        "crashed": True}
        ckpt.wait()
        fence(coord)
        ckpt.save(args.steps - 1, checkpoint_tree(params, state))
        print(f"[train_lm] finished {args.steps} steps in "
              f"{time.time() - t0:.0f}s; checkpoints in {args.ckpt_dir}")
    finally:
        ds.close()
    return {"params": params, "state": state, "losses": losses,
            "crashed": False}


if __name__ == "__main__":
    main()
