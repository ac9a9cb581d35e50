"""Multi-pod dry run: trace every (arch x shape) step on the production
meshes, one process standing for all ranks, and record the roofline
terms (counterpart of ``repro.launch.dryrun``).

For each cell:
  1. the parameter / optimizer / batch / cache inputs are ``DTensor``s
     whose local shards are ``meta`` tensors (shapes only: nothing is
     allocated), placed by ``sharding/rules.py`` — FSDP when the bf16
     parameters over the tensor-parallel degree exceed 4 GB a device;
  2. the step runs once under the activation policy on a **fake process
     group** of 256 ((16, 16)) or 512 ((2, 16, 16)) ranks in this one
     process: ``dist.init_process_group("fake", store=FakeStore())``,
     where ``FakeStore`` is torch's private test utility
     ``torch.testing._internal.distributed.fake_pg.FakeStore`` (the
     ``fake`` backend answers every collective at once and sends
     nothing). Plain tensors the model makes are read as replicated
     (``torch.distributed.tensor.experimental.implicit_replication``);
  3. ``analysis/step_stats.StepCounter`` counts the local ops of rank 0
     and the collectives of DTensor's redistributions; the record, with
     the reference's keys, goes to ``--out`` (default
     ``artifacts/dryrun_torch``), which ``benchmarks/roofline_report.py``
     reads.

What is traced: train is the trainer's own step,
``train_loop.make_train_step`` with remat (its log-softmax
vocabulary-parallel), run on one microbatch: its counts are multiplied
by the microbatch count, and ``microbatch_hook``, the step's
``grad_transform``, counts the float32 accumulation as many times and
the averaging and AdamW once; prefill is the forward's last-position
logits (the encoder-decoder's ``prefill``); decode is ``decode_step`` on
the cache. The counter samples loops (``StepCounter(sample_loops=
True)``): the mamba scan runs one chunk of one step, counted once a
trip, as the reference counts a scan's body times its trips.

Keys with no torch meaning are ``null``: ``compile_s`` (nothing is
compiled), ``hlo_bytes``, ``xla_cost_*_body_once`` (no HLO) and
``memory_per_device["generated_code_size_in_bytes"]``. ``lower_s`` is
the trace's seconds. Memory per device: arguments are the local shard
bytes of the inputs the step reads (``jax.jit`` drops the arguments a
step never reads, so the reference counts only those too: a decode step
reads no encoder weight), the aliased part is what the reference donates
(params + optimizer in train, the cache in decode), outputs are the
local outputs, and temporaries are the peak of live local bytes the
traced ops allocate (``temp_size_method`` names it). The reference's
``--save-hlo`` is dropped: there is no HLO to save.

Importing this module joins no process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.step_stats import StepCounter
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.shapes import ALL_SHAPES, shapes_for
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import (batch_specs, build_model, cache_specs,
                                decode_token_spec)
from repro_torch.models.common import count_params, tree_map
from repro_torch.sharding import act
from repro_torch.sharding import rules as shr
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step

FSDP_THRESHOLD_BYTES = 4 << 30  # per-chip bf16 param budget before FSDP
TEMP_METHOD = "peak live local bytes of the traced ops' storages"


def _mesh_sizes(mesh):
    return act.as_shape(mesh).shape


def pick_rules(cfg, shape, mesh) -> shr.ShardingRules:
    n_params = count_params(build_model(cfg).spec_tree())
    tp = _mesh_sizes(mesh).get("model", 1)
    fsdp = (2 * n_params / tp) > FSDP_THRESHOLD_BYTES
    cp = shape.mode == "decode" and shape.global_batch == 1
    return shr.ShardingRules(fsdp=fsdp, context_parallel=cp)


def pick_opt_cfg(cfg) -> opt.AdamWConfig:
    n_params = count_params(build_model(cfg).spec_tree())
    if n_params > 50e9:  # factored state for the XXL cells (DESIGN.md §3)
        return opt.AdamWConfig(factored_second_moment=True,
                               momentum_dtype="bfloat16")
    return opt.AdamWConfig()


ACT_BUDGET_BYTES = 6 << 30  # per-chip budget for saved layer boundaries


def pick_microbatches(cfg, shape, mesh=None) -> int:
    """Gradient-accumulation factor from the activation-memory model.

    With per-period remat, the live activation state is one boundary
    tensor [tokens_mb/chips_dp, d_model] per period (+ leftovers); nmb
    is the smallest batch divisor keeping that under ACT_BUDGET.
    ``REPRO_NMB`` overrides it; ``REPRO_FLAT_REMAT`` drops the two-level
    remat's smaller boundary count."""
    if os.environ.get("REPRO_NMB"):
        return int(os.environ["REPRO_NMB"])
    sizes = _mesh_sizes(mesh) if mesh is not None else None
    dp = 16 if sizes is None else (
        math.prod(sizes.values()) // sizes.get("model", 1))
    tokens_per_dev = shape.tokens // dp
    n_periods, pattern, leftover = cfg.periods()
    n_boundaries = n_periods + len(leftover) + (
        cfg.encoder_layers if cfg.is_encdec else 0)
    # two-level remat (models/lm.py): NG group boundaries live for the
    # whole step + G transient ones during a group's backward recompute
    if n_periods >= 16 and not cfg.is_encdec and not os.environ.get(
            "REPRO_FLAT_REMAT"):
        g = 1
        for d in range(2, int(n_periods ** 0.5) + 1):
            if n_periods % d == 0:
                g = d
        if g > 1:
            n_boundaries = n_periods // g + g + len(leftover)
    boundary_bytes = n_boundaries * tokens_per_dev * cfg.d_model * 2
    nmb = 1
    while boundary_bytes / nmb > ACT_BUDGET_BYTES and nmb < shape.global_batch:
        nmb *= 2
    return nmb


# ------------------------------------------------------------ fake world
@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, rank 0 (the
    ``fake`` backend completes every collective without sending)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(mesh, shape, placements):
    """Rank 0's shard shape (torch.chunk's split: the first shard is the
    ceil)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return out


def meta_dtensor(mesh, shape, dtype, placements):
    """A ``DTensor`` of global ``shape`` whose local shard is a ``meta``
    tensor."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(mesh, shape, placements), dtype=dtype,
                        device="meta")
    glob = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=glob.shape,
                              stride=glob.stride())


def place(tree, shardings):
    """Each leaf (an ``ArraySpec`` or a ``meta`` tensor) as a meta
    ``DTensor`` with its ``NamedSharding``'s placements."""
    return tree_map(lambda leaf, sh: meta_dtensor(
        sh.mesh, tuple(leaf.shape), leaf.dtype, sh.placements),
        tree, shardings)


def distribute(tree, shardings):
    """Each tensor leaf of ``tree`` (the same on every rank) as a
    ``DTensor`` with its ``NamedSharding``'s placements: the dry run's
    placement run for real (each rank keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, sh: distribute_tensor(t, sh.mesh,
                                                    sh.placements),
                    tree, shardings)


@contextlib.contextmanager
def sharded_scope(mesh, rules):
    """The scope a sharded step is built and run in: the activation
    policy of ``mesh`` (batch over its data axes, the sequence over
    'data' under context parallelism) and the plain tensors the model
    makes read as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    sizes = _mesh_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    seq_axes = ("data",) if rules.context_parallel else ()
    with act.activation_sharding(mesh, batch_axes, seq_axes), \
            implicit_replication():
        yield


def local_bytes(tree, read=None) -> int:
    """Bytes of the local shards of every tensor in a tree; with
    ``read`` (``tree``'s twin and a :class:`StepCounter`), only of the
    leaves whose twin the traced step read."""
    from torch.utils._pytree import tree_leaves as leaves
    total = 0
    twins = leaves(read[0]) if read is not None else leaves(tree)
    for t, twin in zip(leaves(tree), twins):
        if not isinstance(t, torch.Tensor):
            continue
        if read is not None and not read[1].was_read(twin):
            continue
        t = getattr(t, "_local_tensor", t)
        total += t.numel() * t.element_size()
    return total


def opt_state_shardings(params_shardings, opt_cfg, spec_tree, mesh):
    """Moments inherit parameter specs; factored moments drop trailing
    dims (row: the last, col: the one before it)."""
    def v_for(psh, s):
        if opt._is_factored(opt_cfg, s.shape):
            spec = psh.spec
            return {"row": shr.NamedSharding(mesh, tuple(spec[:-1])),
                    "col": shr.NamedSharding(
                        mesh, tuple(spec[:-2]) + (spec[-1],))}
        return psh

    return opt.AdamWState(
        count=shr.NamedSharding(mesh, ()),
        m=params_shardings,
        v=tree_map(v_for, params_shardings, spec_tree))


def opt_state_specs(opt_cfg, spec_tree):
    """``meta`` optimizer state of the parameters' shapes."""
    mdtype = opt._DTYPES[opt_cfg.momentum_dtype]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def v_for(s):
        if opt._is_factored(opt_cfg, s.shape):
            return {"row": meta(s.shape[:-1], torch.float32),
                    "col": meta(s.shape[:-2] + s.shape[-1:], torch.float32)}
        return meta(s.shape, torch.float32)

    return opt.AdamWState(
        count=meta((), torch.int32),
        m=tree_map(lambda s: meta(s.shape, mdtype), spec_tree),
        v=tree_map(v_for, spec_tree))


def _place_opt_state(opt_sds, opt_sh):
    return opt.AdamWState(
        count=place({"c": opt_sds.count}, {"c": opt_sh.count})["c"],
        m=place(opt_sds.m, opt_sh.m), v=place(opt_sds.v, opt_sh.v))


def microbatch_hook(counter, nmb):
    """``make_train_step``'s ``grad_transform`` for a step traced on one
    of ``nmb`` equal microbatches with ``counter.scale`` set to ``nmb``:
    each microbatch's float32 cast and accumulating add (the sum of
    ``nmb`` equal gradients, g + (nmb - 1) g) count ``nmb`` times, as the
    reference's scan body does; then ``scale`` returns to 1 and the
    average, like the AdamW update after it, counts once."""
    def hook(grads):
        if nmb > 1:
            grads = tree_map(lambda g: g.float(), grads)
            grads = tree_map(lambda g: torch.add(g, g, alpha=nmb - 1), grads)
        counter.scale = 1
        if nmb > 1:
            grads = tree_map(lambda g: g / nmb, grads)
        return grads
    return hook


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str] = None, mesh=None,
             rules_override=None) -> dict:
    """Trace one cell and return its record (written to ``out_dir`` when
    given). Without ``mesh`` a fake world of the production mesh's size
    is joined for the cell; with one, its world must be running."""
    if mesh is None:
        sizes = (mesh_mod.PRODUCTION_MULTI_POD if multi_pod
                 else mesh_mod.PRODUCTION)
        with fake_world(math.prod(sizes.values())):
            return run_cell(arch_name, shape_name, multi_pod=multi_pod,
                            out_dir=out_dir, rules_override=rules_override,
                            mesh=mesh_mod.make_production_mesh(
                                multi_pod=multi_pod))
    cfg = get_arch(arch_name)
    shape = ALL_SHAPES[shape_name]
    sizes = _mesh_sizes(mesh)
    mesh_name = "x".join(str(s) for s in sizes.values())
    chips = math.prod(sizes.values())
    model = build_model(cfg)
    rules = rules_override or pick_rules(cfg, shape, mesh)

    t0 = time.time()
    # Specs AND tracing happen under the activation-sharding policy: the
    # head plan (possible head padding) must agree between the parameter
    # spec and the traced apply code.
    with sharded_scope(mesh, rules), torch.no_grad():
        spec_tree = model.spec_tree()
        params_sh = shr.params_shardings(spec_tree, rules, mesh)
        params = place(spec_tree, params_sh)
        alias = 0
        if shape.mode == "train":
            ocfg = pick_opt_cfg(cfg)
            nmb = pick_microbatches(cfg, shape, mesh)
            batch_sds = batch_specs(cfg, shape)
            batch = place(batch_sds, shr.batch_shardings(batch_sds, rules,
                                                         mesh))
            mb_sds = batch_specs(cfg, dataclasses.replace(
                shape, global_batch=shape.global_batch // nmb))
            mb = place(mb_sds, shr.batch_shardings(mb_sds, rules, mesh))
            opt_state = _place_opt_state(
                opt_state_specs(ocfg, spec_tree),
                opt_state_shardings(params_sh, ocfg, spec_tree, mesh))
            args, read = (params, opt_state, batch), (params, opt_state, mb)
            alias = local_bytes((params, opt_state))
            with StepCounter(state=read, sample_loops=True) as counter:
                counter.scale = nmb
                out = make_train_step(
                    model, ocfg, num_microbatches=1, remat=True,
                    grad_transform=microbatch_hook(counter, nmb))(
                        params, opt_state, mb)
        elif shape.mode == "prefill":
            batch_sds = batch_specs(cfg, shape)
            batch = place(batch_sds, shr.batch_shardings(batch_sds, rules,
                                                         mesh))
            args = read = (params, batch)
            with StepCounter(state=read, sample_loops=True) as counter:
                # the compute-relevant prefill: the full forward (k/v are
                # made inside), logits for the last position only
                if cfg.is_encdec:
                    out, _ = model.prefill(params, batch)
                else:
                    out = model.forward(params, batch)[0][:, -1]
        else:  # decode
            cache_sds = cache_specs(cfg, shape, model)
            cache = place(cache_sds, shr.cache_shardings(cache_sds, rules,
                                                         mesh, cfg))
            tok_sds = decode_token_spec(cfg, shape)
            tok = meta_dtensor(mesh, tuple(tok_sds.shape), tok_sds.dtype,
                               act.placements(mesh, shr.batch_pspec(
                                   rules, mesh, tok_sds.dim(),
                                   batch_size=tok_sds.shape[0])))
            args = read = (params, cache, tok)
            alias = local_bytes(cache)
            with StepCounter(state=read, sample_loops=True) as counter:
                out = model.decode_step(params, cache, tok)
    lower_s = time.time() - t0
    stats = counter.stats

    n_total, n_active = rl.count_total_and_active_params(cfg)
    mem_dict = {
        "argument_size_in_bytes": local_bytes(args, (read, counter)),
        "output_size_in_bytes": local_bytes(out),
        "temp_size_in_bytes": counter.peak_live_bytes,
        "generated_code_size_in_bytes": None,
        "alias_size_in_bytes": alias,
        "temp_size_method": TEMP_METHOD,
    }
    roof = rl.Roofline(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=stats.total_flops,
        bytes_per_device=stats.hbm_bytes_opt,
        collective_wire_bytes=stats.collective_wire_bytes,
        collectives=stats.collectives,
        model_flops_total=rl.model_flops(cfg, shape, n_total, n_active),
        memory_per_device=mem_dict,
    )
    record = roof.to_json()
    record.update({
        "rules": {"fsdp": rules.fsdp,
                  "context_parallel": rules.context_parallel},
        "lower_s": lower_s, "compile_s": None,
        "params_total": n_total, "params_active": n_active,
        "hlo_bytes": None,
        "xla_cost_flops_per_device_body_once": None,
        "xla_cost_bytes_per_device_body_once": None,
        "dot_flops_per_device": stats.flops,
        "elementwise_flops_per_device": stats.elementwise_flops,
        "hbm_bytes_upper_per_device": stats.hbm_bytes,
    })
    print(f"[dryrun] {arch_name:24s} {shape_name:12s} mesh={mesh_name:9s} "
          f"flops/dev={roof.flops_per_device:.3e} "
          f"coll={roof.collective_wire_bytes:.3e}B "
          f"bottleneck={roof.bottleneck:10s} (trace {lower_s:.0f}s)",
          flush=True)
    print(f"        memory/device: {mem_dict}", flush=True)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch_name}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for name, cfg in ARCHS.items():
            for shp in shapes_for(cfg):
                cells.append((name, shp.name))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape))

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch_name, shape_name in cells:
        for mp in meshes:
            try:
                run_cell(arch_name, shape_name, multi_pod=mp,
                         out_dir=args.out)
            except Exception as e:  # a failure here is a bug in the system
                failures.append((arch_name, shape_name, mp, repr(e)))
                print(f"[dryrun] FAIL {arch_name} {shape_name} "
                      f"multi_pod={mp}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} dry-run cells passed")


if __name__ == "__main__":
    main()
