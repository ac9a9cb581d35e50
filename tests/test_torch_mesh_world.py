"""The port's mesh runtime on one gloo world of 4 ranks (spawned on this
host by ``launch.mesh.run_world``), against the JAX package on 4 host
devices in one subprocess, the same mesh shapes and numpy-seeded inputs.

* the device barrier: each rank's token is the number of ranks the
  named mesh dimensions span (4 over a (2, 2) mesh, 2 over one axis);
* the hierarchical all-reduce, intra only (``data``: v x 2) and intra +
  inter (``data`` then ``pod``: v x 4 on (2, 2, 1), v x 2 on (2, 1, 2)),
  exact;
* ``compressed_allreduce_int8`` on the (2, 2) mesh's data axis against
  the reference's on the same input: **bit-equal** (the float32 sum has
  two terms, so its order cannot differ);
* ``reshard`` / ``params_shardings`` of the reference's reduced
  qwen3-14b weights under FSDP rules on (2, 2) and on (2, 2, 1), whose
  ``embed`` dims are split over ("pod", "data"): each rank's local shard
  of every leaf equal to the JAX device's shard at the same mesh
  coordinates (``addressable_shards``);
* ``constrain_batch`` / ``constrain_seq_model`` /
  ``constrain_expert_model`` redistributing a replicated ``DTensor`` to
  the placements the reference's entries name, ``full_tensor()``
  unchanged; a plain tensor, and any tensor with no policy, untouched.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_small_mesh, mesh_shape, run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The world's ranks are spawned processes that import this module by
# name to run ``world_checks``: nothing at its top level imports jax
# (the reference runs in a subprocess of its own, JAX_SCRIPT).
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
VECTOR_LEN = 512
HIER_LEN = 64


def int8_input() -> np.ndarray:
    """The compressed all-reduce's global input: the vector the (2, 2)
    mesh's data axis splits in two."""
    return np.random.default_rng(11).standard_normal(VECTOR_LEN).astype(
        np.float32)


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def world_checks(npz: str, rank: int, world: int):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.core.device_barrier import (
        global_device_barrier, make_hierarchical_allreduce)
    from repro_torch.launch.mesh import make_mesh, make_small_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding.act import (
        activation_sharding, constrain_batch, constrain_expert_model,
        constrain_seq_model)
    from repro_torch.sharding.rules import ShardingRules, params_shardings
    from repro_torch.train.compression import compressed_allreduce_int8
    from repro_torch.train.elastic import make_mesh_from_shape, reshard

    assert world == 4
    meshes = {"2x2": make_small_mesh(2, 2)}
    meshes["2x2x1"] = make_mesh_from_shape((2, 2, 1))
    meshes["2x1x2"] = make_mesh(*MESHES["2x1x2"])
    out = {"coords": {k: list(m.get_coordinate()) for k, m in meshes.items()}}
    try:
        make_small_mesh(2, 4)
    except ValueError as e:
        out["refused"] = str(e)

    # the barrier: each rank's token after it
    one = torch.ones(())
    out["barrier"] = {
        f"{k}:{','.join(axes or ())}": float(
            global_device_barrier(meshes[k], axes)(one))
        for k, axes in (("2x2", None), ("2x2", ("data",)),
                        ("2x2", ("model",)), ("2x1x2", None),
                        ("2x1x2", ("pod",)), ("2x2x1", ("pod", "data")))}

    # the hierarchical all-reduce of a vector every rank holds
    v = torch.arange(HIER_LEN, dtype=torch.float32) * 0.5
    out["hier"] = {
        "2x2:data": make_hierarchical_allreduce(meshes["2x2"])(v).numpy(),
        "2x2x1:data+pod": make_hierarchical_allreduce(
            meshes["2x2x1"], inter_axis="pod")(v).numpy(),
        "2x1x2:data+pod": make_hierarchical_allreduce(
            meshes["2x1x2"], inter_axis="pod")(v).numpy()}

    # the int8 all-reduce of this rank's data shard of the global input
    d = meshes["2x2"].get_coordinate()[0]
    half = VECTOR_LEN // 2
    shard = torch.from_numpy(int8_input()[d * half:(d + 1) * half].copy())
    out["int8"] = compressed_allreduce_int8(shard, meshes["2x2"],
                                            "data").numpy()
    try:
        compressed_allreduce_int8(torch.zeros(3), meshes["2x2"], "data")
    except ValueError as e:
        out["int8_refused"] = str(e)

    # reshard the reference's reduced qwen3-14b weights onto each mesh
    data = dict(np.load(npz))
    host = tree_map(torch.from_numpy, unflatten(
        {k[2:]: v for k, v in data.items() if k.startswith("p:")}))
    model = build_model(get_arch("qwen3-14b").reduced())
    out["local"] = {}
    for k in ("2x2", "2x2x1"):
        shardings = params_shardings(model.spec_tree(),
                                     ShardingRules(fsdp=True), meshes[k])
        dts = reshard(host, shardings)
        out["local"][k] = {
            p: (t.to_local().numpy(), [repr(x) for x in t.placements])
            for p, t in tree_leaves(dts)}

    # the constraints redistribute a DTensor to the placements they name
    m = meshes["2x2"]
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    rep = distribute_tensor(x, m, [Replicate(), Replicate()])
    got = {}
    with activation_sharding(m, ("data",)):
        for name, fn in (("batch", constrain_batch),
                         ("seq_model", constrain_seq_model),
                         ("expert_model", constrain_expert_model)):
            y = fn(rep)
            assert isinstance(y, DTensor)
            got[name] = ([repr(p) for p in y.placements],
                         bool(torch.equal(y.full_tensor(), x)))
        got["batch_local_rows"] = bool(torch.equal(
            constrain_batch(rep).to_local(), x[2 * d:2 * d + 2]))
        got["plain_tensor_unchanged"] = constrain_batch(x) is x
    with activation_sharding(m, ()):
        got["no_batch_axes"] = [repr(p) for p in constrain_batch(
            rep).placements]
    got["no_policy"] = constrain_seq_model(rep) is rep
    out["constrain"] = got
    return out


def _fail_on_rank_1(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import build_model
from repro.sharding.rules import ShardingRules, params_shardings
from repro.train.compression import compressed_allreduce_int8
from test_torch_mesh_world import MESHES, int8_input

def mesh(k):
    shape, axes = MESHES[k]
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

out = {}
m = mesh("2x2")
g = jax.device_put(jnp.asarray(int8_input()), NamedSharding(m, P("data")))
out["int8"] = np.asarray(jax.jit(
    lambda x: compressed_allreduce_int8(x, m, "data"))(g))
model = build_model(get_arch("qwen3-14b").reduced())
params = model.init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(params)[0]
key = lambda path: "/".join(str(getattr(p, "key", p)) for p in path)
for path, v in flat:
    out["p:" + key(path)] = np.asarray(v)
for k in ("2x2", "2x2x1"):
    mk = mesh(k)
    sh = params_shardings(model.spec_tree(), ShardingRules(fsdp=True), mk)
    placed = jax.tree_util.tree_map(jax.device_put, params, sh)
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        for idx in np.ndindex(mk.devices.shape):
            dev = mk.devices[idx]
            shard = [s for s in arr.addressable_shards if s.device == dev]
            out[f"s:{k}:{','.join(map(str, idx))}:{key(path)}"] = np.asarray(
                shard[0].data)
np.savez(sys.argv[1], **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    npz = tmp_path_factory.mktemp("mesh") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(npz),
                           str(ROOT / "tests")], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_OK" in proc.stdout
    return str(npz), dict(np.load(npz))


@pytest.fixture(scope="module")
def world(reference):
    return run_world(functools.partial(world_checks, reference[0]), 4,
                     "gloo", timeout=180)


def test_world_answers_in_rank_order(world):
    assert len(world) == 4
    assert [r["coords"]["2x2"] for r in world] == [[0, 0], [0, 1], [1, 0],
                                                   [1, 1]]
    assert [r["coords"]["2x2x1"] for r in world] == [
        [0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]]


def test_device_barrier_token_counts_the_ranks(world):
    want = {"2x2:": 4.0, "2x2:data": 2.0, "2x2:model": 2.0, "2x1x2:": 4.0,
            "2x1x2:pod": 2.0, "2x2x1:pod,data": 4.0}
    for r in world:
        assert r["barrier"] == want


def test_hierarchical_allreduce_is_the_sum(world):
    v = np.arange(HIER_LEN, dtype=np.float32) * 0.5
    for r in world:
        np.testing.assert_array_equal(r["hier"]["2x2:data"], v * 2)
        np.testing.assert_array_equal(r["hier"]["2x2x1:data+pod"], v * 4)
        np.testing.assert_array_equal(r["hier"]["2x1x2:data+pod"], v * 2)


def test_int8_allreduce_bit_equal_to_reference(world, reference):
    want = reference[1]["int8"]
    half = VECTOR_LEN // 2
    for r in world:
        d = r["coords"]["2x2"][0]
        np.testing.assert_array_equal(r["int8"], want[d * half:(d + 1) * half])
    assert all(r["int8_refused"] == "vector of 3 does not split 2 ways "
               "over 'data'" for r in world)
    # and it approximates the exact sum within the reference's bound
    exact = int8_input().reshape(2, half).sum(0)
    err = np.abs(world[0]["int8"] - exact).max()
    assert err < 0.05 * np.abs(exact).max() + 1e-3, err


@pytest.mark.parametrize("mesh", ["2x2", "2x2x1"])
def test_reshard_local_shards_equal_reference(world, reference, mesh):
    ref = reference[1]
    n_split = 0
    for r in world:
        coord = ",".join(map(str, r["coords"][mesh]))
        local = r["local"][mesh]
        want = {k.split(":", 3)[3]: v for k, v in ref.items()
                if k.startswith(f"s:{mesh}:{coord}:")}
        assert sorted(local) == sorted(want)
        for path, (got, placements) in local.items():
            assert got.shape == want[path].shape, (mesh, coord, path)
            np.testing.assert_array_equal(got, want[path], err_msg=path)
            n_split += got.shape != ref["p:" + path].shape
    assert n_split > 0
    if mesh == "2x2x1":
        # FSDP splits 'embed' over ("pod", "data"): 4 ways, pod-major
        emb = world[0]["local"][mesh]["embed/tokens"]
        assert emb[1] == ["Shard(dim=1)", "Shard(dim=1)", "Shard(dim=0)"]
        assert emb[0].shape[1] * 4 == ref["p:embed/tokens"].shape[1]


def test_constraints_redistribute_dtensors(world):
    for r in world:
        c = r["constrain"]
        assert c["batch"] == (["Shard(dim=0)", "Replicate()"], True)
        assert c["seq_model"] == (["Shard(dim=0)", "Shard(dim=1)"], True)
        assert c["expert_model"] == (["Shard(dim=1)", "Shard(dim=0)"], True)
        assert c["batch_local_rows"] and c["plain_tensor_unchanged"]
        assert c["no_batch_axes"] == ["Replicate()", "Replicate()"]
        assert c["no_policy"]


def test_mesh_builders_refuse_a_world_of_another_size(world):
    """A (2, 4) mesh on the world of 4 raises on every rank (it is never
    shrunk); with no world at all, so does a (2, 2) one."""
    for r in world:
        assert r["refused"] == "mesh (2, 4) needs 8 ranks, the world has 4"
    with pytest.raises(RuntimeError, match="no process group"):
        make_small_mesh(2, 2)
    assert mesh_shape({"data": 1, "model": 16}).shape == {"data": 1,
                                                          "model": 16}


def test_run_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_world(_fail_on_rank_1, 2, "gloo", timeout=60)
