"""The port's step statistics against the JAX package's HLO analysis:
the dot flops of the reference test's three programs (a matmul + tanh,
a 7-step scan, a 5 x 3 nested scan) written as torch loops; a column-
then row-parallel matmul pair on a fake (2, 4) world against the same
function compiled by JAX on 8 host devices (per-device dot flops, the
all-reduce count and wire bytes, exactly, in float32: XLA's CPU backend
all-reduces a bf16 sum in float32); a replicated matmul counted
in full on every device; and the collective counts against torch's own
``CommDebugMode``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_stats import analyze as hlo_analyze
from repro_torch.analysis import step_stats
from repro_torch.analysis.step_stats import StepCounter, wire_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _jax_stats(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_analyze(jax.jit(f).lower(*args).compile().as_text(),
                       n_devices=1)


def test_unscanned_flops_match_the_hlo():
    st = step_stats.analyze(lambda a, b: torch.tanh(a @ b).sum(),
                            _meta(64, 128), _meta(128, 256))
    ref = _jax_stats(lambda a, b: jnp.tanh(a @ b).sum(), (64, 128),
                     (128, 256))
    assert st.flops == ref.flops == 2 * 64 * 128 * 256
    # tanh's output elements: one flop each, as the HLO's tanh counts
    assert st.elementwise_flops == 64 * 256


def test_scan_as_a_loop_matches_the_hlo_trip_count():
    def f(w, x):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x.sum()

    def jf(w, x):
        def body(x, wi):
            return x @ wi, 0
        x, _ = jax.lax.scan(body, x, w)
        return x.sum()

    st = step_stats.analyze(f, _meta(7, 32, 32), _meta(8, 32))
    ref = _jax_stats(jf, (7, 32, 32), (8, 32))
    assert st.flops == ref.flops == 7 * 2 * 8 * 32 * 32


def test_nested_scan_as_loops_matches_the_hlo():
    def f(w, x):
        for i in range(w.shape[0]):
            for _ in range(3):
                x = x @ w[i]
        return x.sum()

    def jf(w, x):
        def outer(x, wi):
            def inner(x, _):
                return x @ wi, 0
            x, _ = jax.lax.scan(inner, x, jnp.arange(3))
            return x, 0
        x, _ = jax.lax.scan(outer, x, w)
        return x.sum()

    st = step_stats.analyze(f, _meta(5, 16, 16), _meta(4, 16))
    ref = _jax_stats(jf, (5, 16, 16), (4, 16))
    assert st.flops == ref.flops == 5 * 3 * 2 * 4 * 16 * 16


def test_scaled_body_equals_the_loop():
    """One trip traced at ``scale`` 4 gives the counts of the loop of 4
    (what the dry run does with microbatches)."""
    w, x = _meta(32, 32), _meta(8, 32)
    with StepCounter() as one:
        one.scale = 4
        torch.tanh(x @ w)
    four = step_stats.analyze(lambda: [torch.tanh(x @ w) for _ in range(4)])
    assert one.stats.to_json() == four.to_json()


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_sampled_mamba_scan_counts_the_whole_loop(mode):
    """Reduced falcon-mamba at 256 tokens (2 chunks of 128 steps), traced
    with ``sample_loops`` (one chunk of one step, counted 2 x 128 times)
    and in full. The forward counts equal in every field; in training the
    dot flops and the optimistic bytes equal, and the elementwise flops
    and upper-bound bytes are lower: the eager loop's autograd sums one
    full-size gradient per step's slice (quadratic in the chunk), which
    one sampled trip does not repeat, as XLA's scan does not."""
    import dataclasses
    from repro_torch.configs import ALL_SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import batch_specs, build_model
    from repro_torch.models.common import shape_params
    from repro_torch.train.train_loop import make_train_step
    cfg = get_arch("falcon-mamba-7b").reduced()
    model = build_model(cfg)
    ocfg = dryrun.pick_opt_cfg(cfg)
    spec_tree = model.spec_tree()
    params = shape_params(spec_tree)
    state = dryrun.opt_state_specs(ocfg, spec_tree)
    batch = batch_specs(cfg, dataclasses.replace(
        ALL_SHAPES["train_4k"], global_batch=1, seq_len=256))
    got = {}
    for sample in (False, True):
        with StepCounter(state=(params,), sample_loops=sample) as c:
            if mode == "train":
                make_train_step(model, ocfg, num_microbatches=1,
                                remat=True)(params, state, batch)
            else:
                with torch.no_grad():
                    model.forward(params, batch)
        assert c.scale == 1
        got[sample] = c.stats
    full, sampled = got[False], got[True]
    assert sampled.flops == full.flops > 0
    assert sampled.hbm_bytes_opt == full.hbm_bytes_opt
    if mode == "prefill":
        assert sampled.to_json() == full.to_json()
    else:
        assert 0 < sampled.elementwise_flops < full.elementwise_flops
        assert 0 < sampled.hbm_bytes < full.hbm_bytes


@pytest.mark.parametrize("kind,g,want", [
    ("all-reduce", 4, 2 * 0.75 * 100), ("all-gather", 4, 0.75 * 100),
    ("reduce-scatter", 4, 0.75 * 100 * 4), ("all-to-all", 2, 50.0),
    ("collective-permute", 2, 100.0), ("all-reduce", 1, 0.0)])
def test_wire_byte_formulas(kind, g, want):
    assert wire_bytes(kind, 100, g) == want


def test_peak_live_bytes_follow_frees():
    x = _meta(1024)           # 4 KiB, an argument: not a temporary
    with StepCounter(state=[x]) as c:
        y = x * 2             # +4 KiB
        z = y * 2             # +4 KiB (peak 8)
        del y                 # -4 KiB
        w = z + 1             # +4 KiB (peak 8)
    assert c.peak_live_bytes == 8192
    assert c.live_bytes == 8192
    del z, w


# --------------------------------------------------- sharded (fake world)
B, D, F = 64, 128, 256

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.analysis.hlo_stats import analyze
B, D, F = %d, %d, %d
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
sh = lambda *s: NamedSharding(mesh, P(*s))
f = jax.jit(lambda x, w1, w2: (x @ w1) @ w2,
            in_shardings=(sh("data", None), sh(None, "model"),
                          sh("model", None)),
            out_shardings=sh("data", None))
sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((B, D), (D, F), (F, D))]
st = analyze(f.lower(*sds).compile().as_text(), n_devices=8)
g = jax.jit(lambda x, w: x @ w, in_shardings=(sh(), sh()), out_shardings=sh())
rep = analyze(g.lower(*sds[:2]).compile().as_text(), n_devices=8)
print("RESULT:" + json.dumps({"pair": st.to_json(), "replicated": rep.flops}))
""" % (B, D, F)


@pytest.fixture(scope="module")
def jax_sharded():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def fake_mesh():
    from repro_torch.launch.dryrun import fake_world
    with fake_world(8):
        from repro_torch.launch.mesh import make_mesh
        yield make_mesh((2, 4), ("data", "model"))


def _dt(mesh, shape, placements):
    from repro_torch.launch.dryrun import meta_dtensor
    return meta_dtensor(mesh, shape, torch.float32, placements)


def _pair(mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = _dt(mesh, (B, D), (Shard(0), Replicate()))
    w1 = _dt(mesh, (D, F), (Replicate(), Shard(1)))
    w2 = _dt(mesh, (F, D), (Replicate(), Shard(0)))

    def f():
        y = (x @ w1) @ w2
        return y.redistribute(mesh, (Shard(0), Replicate()))
    return f


def test_sharded_pair_matches_the_partitioned_hlo(fake_mesh, jax_sharded):
    st = step_stats.analyze(_pair(fake_mesh))
    ref = jax_sharded["pair"]
    assert st.flops == ref["dot_flops"] == 2 * 2 * (B // 2) * D * (F // 4)
    ar, jar = st.collectives["all-reduce"], ref["collectives"]["all-reduce"]
    assert ar["count"] == jar["count"] == 1
    assert ar["wire_bytes"] == jar["wire_bytes"] \
        == 2 * 0.75 * (B // 2) * D * 4
    assert st.collective_wire_bytes == ref["collective_wire_bytes"]


def test_replicated_matmul_counts_in_full(fake_mesh, jax_sharded):
    from torch.distributed.tensor import Replicate
    rep = (Replicate(), Replicate())
    x, w = _dt(fake_mesh, (B, D), rep), _dt(fake_mesh, (D, F), rep)
    st = step_stats.analyze(lambda: x @ w)
    assert st.flops == jax_sharded["replicated"] == 2 * B * D * F
    assert st.collective_wire_bytes == 0


def test_collective_counts_match_comm_debug_mode(fake_mesh):
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        st = step_stats.analyze(_pair(fake_mesh))
    total = sum(c["count"] for c in st.collectives.values())
    assert total == comm.get_total_counts() == 1
