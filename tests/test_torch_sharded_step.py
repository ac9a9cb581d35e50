"""The dry run's sharded train step run for real: reduced gemma3-1b on a
gloo world of 4 ranks, with the parameters, optimizer state and batch
placed as ``DTensor``s by the dry run's own code (``launch/dryrun.py``:
the sharding rules, the optimizer state specs, the activation policy,
the vocabulary-parallel loss). Two meshes: (2, 2) ``("data", "model")``,
the ``'shard'`` head plan; and (1, 4) with two query heads, the
``'seq'`` plan (each rank's band of query positions, the kv-chunked
global layer). Every rank's loss and updated parameters match the same
step on one process within 1e-4 x max(1, max |reference|), leaf by
leaf, and so do the gradients, within 1e-4 x max(1e-2, max |reference|)
(AdamW's first update is about lr x sign(g), so the parameters alone
would not show a wrong gradient).

The dry run's sharded decode step run for real: reduced qwen3-14b on the
(2, 2) mesh, its parameters, cache and tokens placed by the same code,
with four kv heads (the cache split on its kv heads over 'model'), with
one (kv heads that do not divide 'model': the cache split on head_dim,
partial scores all-reduced), and with one row (context parallelism: the
cache's time axis split over 'data', the new position written by the
shard that holds it). Every rank's logits and updated cache match one
process within 1e-4 x max(1, max |reference|).

The ranks import this module by name (``run_world``), so it imports no
JAX."""

import dataclasses

import pytest
import torch

WORLD = 4
SEED = 0


MESHES = {"shard": ((2, 2), 4), "seq": ((1, 4), 2)}   # mesh, query heads


def _setup(plan="shard"):
    from repro_torch.configs import ALL_SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, make_batch
    cfg = dataclasses.replace(get_arch("gemma3-1b").reduced(),
                              num_heads=MESHES[plan][1])
    shape = dataclasses.replace(ALL_SHAPES["train_4k"], global_batch=4,
                                seq_len=32)
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg)
    params = model.init(gen, "cpu")
    batch = make_batch(cfg, shape, gen)
    return cfg, shape, model, params, batch, dryrun.pick_opt_cfg(cfg)


def _rank_shard(rank, world):
    return _rank("shard")


def _rank_seq(rank, world):
    return _rank("seq")


def _rank(plan):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import head_plan
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import rules as shr
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (make_loss_fn, make_train_step,
                                              value_and_grad)
    cfg, shape, model, params, batch, ocfg = _setup(plan)
    mesh = make_mesh(MESHES[plan][0], ("data", "model"))
    rules = dryrun.pick_rules(cfg, shape, mesh)
    with dryrun.sharded_scope(mesh, rules):
        assert head_plan(cfg.num_heads)[0] == plan
        spec_tree = model.spec_tree()
        psh = shr.params_shardings(spec_tree, rules, mesh)
        d_params = dryrun.distribute(params, psh)
        state = opt.init(ocfg, params)
        osh = dryrun.opt_state_shardings(psh, ocfg, spec_tree, mesh)
        d_state = opt.AdamWState(
            count=dryrun.distribute({"c": state.count},
                                    {"c": osh.count})["c"],
            m=dryrun.distribute(state.m, osh.m),
            v=dryrun.distribute(state.v, osh.v))
        d_batch = dryrun.distribute(batch, shr.batch_shardings(batch, rules,
                                                               mesh))
        new_params, _, metrics = make_train_step(
            model, ocfg, num_microbatches=1, remat=True)(
                d_params, d_state, d_batch)
        full = {p: t.full_tensor().numpy()
                for p, t in tree_leaves(new_params)}
        loss = float(metrics["loss"].full_tensor())
        _, grads = value_and_grad(make_loss_fn(model, remat=True), d_params,
                                  d_batch)
        grads = {p: t.full_tensor().numpy() for p, t in tree_leaves(grads)}
    placed = {p: str(t.placements) for p, t in tree_leaves(d_params)}
    return loss, full, grads, placed


@pytest.mark.parametrize("plan", sorted(MESHES))
def test_sharded_step_matches_one_process(plan):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (make_loss_fn, make_train_step,
                                              value_and_grad)
    cfg, shape, model, params, batch, ocfg = _setup(plan)
    torch.set_num_threads(1)
    ref_params, _, ref_metrics = make_train_step(
        model, ocfg, num_microbatches=1, remat=True)(
            params, opt.init(ocfg, params), batch)
    ref = dict(tree_leaves(ref_params))
    ref_loss = float(ref_metrics["loss"])
    _, ref_grads = value_and_grad(make_loss_fn(model, remat=True), params,
                                  batch)
    ref_grads = dict(tree_leaves(ref_grads))
    out = run_world(_rank_shard if plan == "shard" else _rank_seq, WORLD,
                    "gloo", timeout=120.0)
    for loss, full, grads, placed in out:
        assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
        assert full.keys() == ref.keys() == grads.keys()
        for path, want in ref.items():
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            err = float((torch.from_numpy(full[path]) - want).abs().max())
            assert err <= tol, (path, err, tol)
            g = ref_grads[path]
            tol = 1e-4 * max(1e-2, float(g.abs().max()))
            err = float((torch.from_numpy(grads[path]) - g).abs().max())
            assert err <= tol, ("grad", path, err, tol)
    # the step really ran sharded: tensor-parallel and data-parallel
    # placements both occur among the parameters
    placed = out[0][3]
    assert any("Shard" in p for p in placed.values())


DECODE_LEN = 16
# kv heads, rows, the cache dims split over 'data' and over 'model'
DECODE = {"kv_heads": (4, 4, (1, 3)), "head_dim": (1, 4, (1, 4)),
          "time": (1, 1, (2, 4))}


def _decode_setup(split):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    cfg = dataclasses.replace(get_arch("qwen3-14b").reduced(),
                              num_kv_heads=DECODE[split][0])
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg)
    params = model.init(gen, "cpu")
    rows = DECODE[split][1]
    cache = model.init_cache(rows, DECODE_LEN, "cpu")
    for _, t in tree_leaves(cache):
        if t.is_floating_point():
            t.normal_(generator=gen)
    cache["len"].fill_(DECODE_LEN // 2)
    tok = torch.randint(0, cfg.vocab_size, (rows,), generator=gen,
                        dtype=torch.int32)
    return cfg, model, params, cache, tok


def _rank_decode_kv(rank, world):
    return _rank_decode("kv_heads")


def _rank_decode_hd(rank, world):
    return _rank_decode("head_dim")


def _rank_decode_time(rank, world):
    return _rank_decode("time")


def _rank_decode(split):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ALL_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import rules as shr
    cfg, model, params, cache, tok = _decode_setup(split)
    mesh = make_mesh((2, 2), ("data", "model"))
    rows = DECODE[split][1]
    shape = dataclasses.replace(ALL_SHAPES["decode_32k"],
                                global_batch=rows, seq_len=DECODE_LEN)
    rules = dryrun.pick_rules(cfg, shape, mesh)
    with dryrun.sharded_scope(mesh, rules):
        psh = shr.params_shardings(model.spec_tree(), rules, mesh)
        d_cache = dryrun.distribute(cache, shr.cache_shardings(
            cache, rules, mesh, cfg))
        placed = {p: tuple(t.placements) for p, t in tree_leaves(d_cache)}
        d_tok = dryrun.distribute({"t": tok}, {"t": shr.NamedSharding(
            mesh, shr.batch_pspec(rules, mesh, 1, batch_size=rows))})["t"]
        logits, new_cache = model.decode_step(dryrun.distribute(params, psh),
                                              d_cache, d_tok)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    return (whole(logits), {p: whole(t) for p, t in tree_leaves(new_cache)},
            {p: [(type(x).__name__, getattr(x, "dim", None)) for x in pl]
             for p, pl in placed.items()})


@pytest.mark.parametrize("split", sorted(DECODE))
def test_sharded_decode_matches_one_process(split):
    import copy
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.common import tree_leaves
    cfg, model, params, cache, tok = _decode_setup(split)
    torch.set_num_threads(1)
    ref_logits, ref_cache = model.decode_step(params, copy.deepcopy(cache),
                                              tok)
    ref_cache = dict(tree_leaves(ref_cache))
    rank_fn = {"kv_heads": _rank_decode_kv, "head_dim": _rank_decode_hd,
               "time": _rank_decode_time}[split]
    out = run_world(rank_fn, WORLD, "gloo", timeout=120.0)
    for logits, got_cache, placed in out:
        tol = 1e-4 * max(1.0, float(ref_logits.abs().max()))
        err = float((torch.from_numpy(logits) - ref_logits).abs().max())
        assert err <= tol, ("logits", err, tol)
        assert got_cache.keys() == ref_cache.keys()
        for path, want in ref_cache.items():
            want = want.float()
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            err = float((torch.from_numpy(got_cache[path]).float()
                         - want).abs().max())
            assert err <= tol, (path, err, tol)
    # the cache really was split where the case says: batch or time over
    # 'data' (mesh dim 0), kv heads or head_dim over 'model' (mesh dim 1)
    k = [pl for p, pl in out[0][2].items() if p.endswith("k")]
    want = [("Shard", d) for d in DECODE[split][2]]
    assert k and all(pl == want for pl in k), k
