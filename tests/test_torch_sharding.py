"""The port's sharding rules, logical axes and elastic mesh shapes
against the JAX package, on the CPU, with no process group.

* The reference's own six cases (tests/test_sharding.py) on the port.
* ``logical_tree`` equal to the reference's for all ten architectures
  at full width, with no policy (tp 1) and under a (16, 16) mesh (tp 16:
  the ``'pad'`` plan stores 48 of qwen3's 40 heads) — spec trees only,
  nothing allocated; ``shape_params`` gives ``meta`` tensors.
* ``params_pspecs`` and ``explain`` equal to the reference's for all ten
  at full width on the (16, 16), (2, 16, 16) and (2, 4) meshes under the
  default, FSDP and context-parallel rules, each spec tree built under
  its mesh's policy; ``batch_pspec`` over a grid of cases.
* ``cache_pspecs`` for the reduced cache of every family against the
  reference's ``cache_shardings`` on a real (2, 4) host-device mesh (one
  JAX subprocess), at batch 4 and, context-parallel, batch 1.
* ``placements``: a spec on a mesh as DTensor placements, a dim split
  over ("pod", "data") split pod-major.
* ``choose_mesh_shape`` / ``survivors_mesh``.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.models.common import logical_tree as jlogical_tree
from repro.sharding import rules as jrules
from repro.sharding.act import activation_sharding as jpolicy
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import build_model
from repro_torch.models.common import (ArraySpec, logical_tree, shape_params,
                                       tree_leaves)
from repro_torch.sharding import rules
from repro_torch.sharding.act import MeshShape, activation_sharding, placements
from repro_torch.sharding.rules import ShardingRules, pspec_for
from repro_torch.train.elastic import choose_mesh_shape, survivors_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """The reference tests' duck-typed mesh (axis names + shape dict)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = MeshShape({"data": 16, "model": 16})
MESH3 = MeshShape({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
RULES = {"default": {}, "fsdp": {"fsdp": True},
         "context_parallel": {"context_parallel": True}}


# ------------------------------------------------- the reference's cases
def test_tp_sharding_basic():
    r = ShardingRules()
    assert pspec_for(("embed", "heads", "head_dim"), (8192, 64, 128),
                     r, MESH) == (None, "model", None)
    assert pspec_for(("embed", "mlp"), (8192, 49152), r, MESH) == \
        (None, "model")
    assert pspec_for(("vocab", "embed"), (152064, 8192), r, MESH) == \
        ("model", None)


def test_gqa_kv_fallback_to_replication():
    assert pspec_for(("embed", "kv_heads", "head_dim"), (8192, 8, 128),
                     ShardingRules(), MESH) == (None, None, None)


def test_moe_conflict_resolution():
    r = ShardingRules(fsdp=True)
    assert pspec_for(("expert", "embed", "mlp"), (16, 8192, 24576), r,
                     MESH) == ("model", "data", None)
    assert pspec_for(("expert", "embed", "mlp"), (16, 8192, 24576), r,
                     MESH3) == ("model", ("pod", "data"), None)


def test_fsdp_divisibility_fallback():
    assert pspec_for(("embed",), (1150,), ShardingRules(fsdp=True),
                     MESH) == (None,)


def test_layer_axis_never_sharded():
    got = pspec_for(("layer", "embed", "mlp"), (40, 5120, 17408),
                    ShardingRules(), MESH)
    assert got[0] is None


def test_elastic_mesh_shapes():
    assert choose_mesh_shape(256, 16) == (16, 16)
    assert choose_mesh_shape(512, 16, pods=2) == (2, 16, 16)
    assert survivors_mesh(240, 16) == (15, 16)
    assert survivors_mesh(250, 16) == (15, 16)
    with pytest.raises(ValueError):
        survivors_mesh(8, 16)


def test_elastic_mesh_shapes_match_reference():
    from repro.train import elastic as jelastic
    for n in (1, 8, 16, 31, 64, 250, 256, 384, 512, 1000):
        for mp in (1, 4, 16):
            for pods in (1, 2):
                for fn, jfn in ((choose_mesh_shape,
                                 jelastic.choose_mesh_shape),
                                (survivors_mesh, jelastic.survivors_mesh)):
                    try:
                        want = jfn(n, mp, pods)
                    except ValueError:
                        with pytest.raises(ValueError):
                            fn(n, mp, pods)
                        continue
                    assert fn(n, mp, pods) == want, (fn, n, mp, pods)


# ------------------------------------------------------- logical axes
def _flat_jax(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


def _trees(name, mesh):
    """(reference spec tree, port spec tree) of an arch at full width,
    built under ``mesh``'s policy (None: no policy)."""
    if mesh is None:
        return jbuild(jget_arch(name)).spec_tree(), build_model(
            get_arch(name)).spec_tree()
    with jpolicy(FakeMesh(mesh), ()), activation_sharding(
            MeshShape(mesh), ()):
        return jbuild(jget_arch(name)).spec_tree(), build_model(
            get_arch(name)).spec_tree()


def test_the_ten_architectures():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logical_tree_equals_reference(name, tp):
    jt, tt = _trees(name, None if tp == 1 else MESHES["16x16"])
    want = _flat_jax(jlogical_tree(jt), is_leaf=lambda x: isinstance(
        x, tuple))
    got = dict(tree_leaves(logical_tree(tt)))
    assert got == want
    shapes = {p: tuple(s.shape) for p, s in _flat_jax(
        jt, is_leaf=lambda x: hasattr(x, "logical")).items()}
    meta = dict(tree_leaves(shape_params(tt)))
    assert {p: tuple(t.shape) for p, t in meta.items()} == shapes
    assert all(t.device.type == "meta" for t in meta.values())


def test_pad_plan_stores_padded_heads_at_tp16():
    _, tt = _trees("qwen3-14b", MESHES["16x16"])
    wq = tt["periods"]["layer_0"]["mixer"]["wq"]
    assert wq.shape == (40, 5120, 48, 128)
    assert wq.logical == ("layer", "embed", "heads", "head_dim")
    with pytest.raises(AssertionError):
        ArraySpec((2, 3), torch.float32, ("embed",))


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_params_pspecs_and_explain_equal_reference(name, mesh, rule):
    jt, tt = _trees(name, MESHES[mesh])
    jm, tm = FakeMesh(MESHES[mesh]), MeshShape(MESHES[mesh])
    jr, tr = jrules.ShardingRules(**RULES[rule]), ShardingRules(**RULES[rule])
    want = {p: tuple(s) for p, s in _flat_jax(
        jrules.params_pspecs(jt, jr, jm),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)).items()}
    got = dict(tree_leaves(rules.params_pspecs(tt, tr, tm)))
    assert got == want
    assert rules.explain(tt, tr, tm) == jrules.explain(jt, jr, jm)


def test_batch_pspec_equals_reference():
    n = 0
    for mesh in ({"data": 16, "model": 16}, {"pod": 2, "data": 16,
                                              "model": 16},
                 {"data": 2, "model": 4}, {"model": 8}):
        for rule in RULES.values():
            for ndim, seq_axis in ((1, None), (2, 1), (3, 1)):
                for b in (None, 1, 2, 16, 32, 48):
                    want = jrules.batch_pspec(
                        jrules.ShardingRules(**rule), FakeMesh(mesh), ndim,
                        seq_axis=seq_axis, batch_size=b)
                    got = rules.batch_pspec(
                        ShardingRules(**rule), MeshShape(mesh), ndim,
                        seq_axis=seq_axis, batch_size=b)
                    assert got == tuple(want), (mesh, rule, ndim, b)
                    n += 1
    assert n == 4 * 3 * 3 * 6


def test_placements_split_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    m = MeshShape({"pod": 2, "data": 2, "model": 2})
    assert placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(m, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(m, (("data", "pod"),))


# ----------------------------------------------------------------- caches
CACHE_SCRIPT = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import ARCHS, get_arch
from repro.models import build_model
from repro.sharding.rules import ShardingRules, cache_shardings

mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for name in sorted(ARCHS):
    cfg = get_arch(name).reduced()
    m = build_model(cfg)
    for b, cp in ((4, False), (1, True), (3, False)):
        cache = m.init_cache(b, 16)
        sh = cache_shardings(cache, ShardingRules(context_parallel=cp),
                             mesh, cfg)
        flat, _ = jax.tree_util.tree_flatten_with_path(sh)
        out[f"{name}/{b}/{cp}"] = {
            "/".join(str(getattr(p, "key", p)) for p in path):
                [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for path, s in flat}
print("CACHE:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cache_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", CACHE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("CACHE:")]
    return json.loads(line[0][len("CACHE:"):])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_specs_equal_reference(name, reference_cache_specs):
    cfg = get_arch(name).reduced()
    m = build_model(cfg)
    mesh = MeshShape({"data": 2, "model": 4})
    for b, cp in ((4, False), (1, True), (3, False)):
        cache = m.init_cache(b, 16, "cpu")
        specs = rules.cache_pspecs(cache, ShardingRules(context_parallel=cp),
                                   mesh, cfg)
        got = {p: [list(e) if isinstance(e, tuple) else e for e in s]
               for p, s in tree_leaves(specs)}
        assert got == reference_cache_specs[f"{name}/{b}/{cp}"], (b, cp)
