"""The port's dry run against the JAX package's: the cell pickers
(sharding rules, optimizer, microbatches) for every cell on both
production meshes, also under ``REPRO_NMB`` and ``REPRO_FLAT_REMAT``;
four reduced cells, one per mode and the mamba scan's prefill (its
loop sampled: one chunk of one step counted per trip), traced on a
fake (2, 4) world and
held to the reference's ``run_cell`` on 8 host devices (one subprocess):
parameter counts, model flops and argument bytes equal, dot flops per
device within the tolerance written below, the record's keys equal; and
the microbatch identity (one microbatch traced and scaled gives the dot
flops of the whole step traced).

Tolerances, written before the first comparison: dot flops per device
within 2 % for prefill and decode, 10 % for train. Train differs because
``torch.utils.checkpoint`` recomputes every checkpointed op in the
backward, where XLA's common-subexpression pass folds some of the
recomputation of ``jax.checkpoint`` into the forward."""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ALL_SHAPES, ARCHS, get_arch, shapes_for
from repro_torch.launch import dryrun
from repro_torch.sharding.act import MeshShape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_flags = os.environ.get("XLA_FLAGS")
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import ALL_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402  (sets XLA_FLAGS)

if _flags is None:                      # leave this worker's jax alone
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s.name) for a in sorted(ARCHS) for s in shapes_for(ARCHS[a])]
REDUCED = [("gemma3-1b", "train_4k"), ("whisper-small", "decode_32k"),
           ("olmoe-1b-7b", "prefill_32k"), ("falcon-mamba-7b", "prefill_32k")]
TOLERANCE = {"train": 0.10, "prefill": 0.02, "decode": 0.02}


class _JaxMesh:
    """What the reference's pickers read of a mesh: ``shape`` and
    ``devices.size``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

        class _Devices:
            size = 1
        for v in shape.values():
            _Devices.size *= v
        self.devices = _Devices


@pytest.mark.parametrize("env", [{}, {"REPRO_NMB": "4"},
                                 {"REPRO_FLAT_REMAT": "1"}],
                         ids=["default", "nmb", "flat_remat"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pickers_match_the_reference(mesh, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shape_of = MESHES[mesh]
    port_mesh, ref_mesh = MeshShape(shape_of), _JaxMesh(shape_of)
    for arch, shape in CELLS:
        cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
        shp, jshp = ALL_SHAPES[shape], J_SHAPES[shape]
        got = dryrun.pick_rules(cfg, shp, port_mesh)
        want = jdryrun.pick_rules(jcfg, jshp, ref_mesh)
        assert (got.fsdp, got.context_parallel) == (
            want.fsdp, want.context_parallel), (arch, shape)
        assert dryrun.pick_microbatches(cfg, shp, port_mesh) == \
            jdryrun.pick_microbatches(jcfg, jshp, ref_mesh), (arch, shape)
        assert dryrun.pick_microbatches(cfg, shp) == \
            jdryrun.pick_microbatches(jcfg, jshp), (arch, shape)
        ocfg, jocfg = dryrun.pick_opt_cfg(cfg), jdryrun.pick_opt_cfg(jcfg)
        assert (ocfg.factored_second_moment, ocfg.momentum_dtype) == (
            jocfg.factored_second_moment, jocfg.momentum_dtype), arch


def test_factored_optimizer_state_specs():
    """The factored moments of qwen1.5-110b drop a trailing dim each, in
    shape and in spec, as the reference's do."""
    from repro_torch.models import build_model
    from repro_torch.sharding import rules as shr
    cfg = get_arch("qwen1.5-110b")
    ocfg = dryrun.pick_opt_cfg(cfg)
    assert ocfg.factored_second_moment
    mesh = MeshShape(MESHES["multi"])
    spec_tree = build_model(cfg).spec_tree()
    rules = dryrun.pick_rules(cfg, ALL_SHAPES["train_4k"], mesh)
    psh = shr.params_shardings(spec_tree, rules, mesh)
    sds = dryrun.opt_state_specs(ocfg, spec_tree)
    sh = dryrun.opt_state_shardings(psh, ocfg, spec_tree, mesh)
    up, up_v = spec_tree["periods"]["layer_0"]["ffn"]["up"], \
        sds.v["periods"]["layer_0"]["ffn"]["up"]
    assert tuple(up_v["row"].shape) == up.shape[:-1]
    assert tuple(up_v["col"].shape) == up.shape[:-2] + up.shape[-1:]
    spec = psh["periods"]["layer_0"]["ffn"]["up"].spec
    v_sh = sh.v["periods"]["layer_0"]["ffn"]["up"]
    assert v_sh["row"].spec == spec[:-1]
    assert v_sh["col"].spec == spec[:-2] + spec[-1:]
    assert sds.m["final_norm"]["scale"].dtype == torch.bfloat16


# ------------------------------------------------- reduced cells vs JAX
JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.launch import dryrun
dryrun.get_arch = lambda name: get_arch(name).reduced()
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split("/")
    out[cell] = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh)
print("RESULT:" + json.dumps(out))
"""


def _reference_records(cells):
    """The reference's ``run_cell`` records of reduced ``cells`` on 8
    host devices, a (2, 4) mesh (one subprocess)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT] + [f"{a}/{s}" for a, s in cells],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    return json.loads(line[0][len("RESULT:"):])


def _port_records(cells):
    """The port's records of reduced ``cells`` on a fake (2, 4) world."""
    from repro_torch.launch.mesh import make_mesh
    real = dryrun.get_arch
    dryrun.get_arch = lambda name: get_arch(name).reduced()
    try:
        with dryrun.fake_world(8):
            mesh = make_mesh((2, 4), ("data", "model"))
            return {f"{a}/{s}": dryrun.run_cell(a, s, multi_pod=False,
                                                mesh=mesh)
                    for a, s in cells}
    finally:
        dryrun.get_arch = real


@pytest.fixture(scope="module")
def reference_cells():
    return _reference_records(REDUCED)


@pytest.fixture(scope="module")
def port_cells():
    return _port_records(REDUCED)


@pytest.mark.parametrize("arch,shape", REDUCED)
def test_reduced_cell_matches_the_reference(arch, shape, port_cells,
                                            reference_cells):
    got, want = port_cells[f"{arch}/{shape}"], \
        reference_cells[f"{arch}/{shape}"]
    assert set(got) == set(want)
    assert set(want["memory_per_device"]) <= set(got["memory_per_device"])
    for key in ("params_total", "params_active", "model_flops_total",
                "chips", "mesh", "rules"):
        assert got[key] == want[key], key
    assert got["memory_per_device"]["argument_size_in_bytes"] == \
        want["memory_per_device"]["argument_size_in_bytes"]
    assert got["memory_per_device"]["alias_size_in_bytes"] == \
        want["memory_per_device"]["alias_size_in_bytes"]
    tol = TOLERANCE[ALL_SHAPES[shape].mode]
    assert got["dot_flops_per_device"] == pytest.approx(
        want["dot_flops_per_device"], rel=tol)
    assert got["collective_wire_bytes"] > 0
    for key in ("compile_s", "hlo_bytes",
                "xla_cost_flops_per_device_body_once",
                "xla_cost_bytes_per_device_body_once"):
        assert got[key] is None


def test_chip_smoke_gates_the_reference_keys(reference_cells):
    """Phase 17 gates each record on the reference's keys: its list is
    the reference's record, key for key."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_keys", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for rec in reference_cells.values():
        assert set(smoke.DRYRUN_KEYS) == set(rec)
    assert len(smoke.DRYRUN_KEYS) == len(set(smoke.DRYRUN_KEYS))


def test_cli_writes_a_record(tmp_path, monkeypatch):
    """``main`` with the reference's arguments writes one record per cell
    under ``--out``, and exits 1 when a cell fails."""
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: get_arch(name).reduced())
    monkeypatch.setattr(mesh_mod, "PRODUCTION", {"data": 2, "model": 2})
    dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    (rec,) = [json.loads(p.read_text()) for p in tmp_path.iterdir()]
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-small", "--shape", "no_such_shape",
                     "--out", str(tmp_path)])


# ------------------------------------------------- microbatch identity
def test_one_microbatch_scaled_equals_the_whole_step():
    """The trainer's step traced on one of two microbatches, scaled by
    ``microbatch_hook``, counts the dot flops of the two-microbatch step
    traced whole."""
    import dataclasses
    from repro_torch.analysis.step_stats import StepCounter
    from repro_torch.models import batch_specs, build_model
    from repro_torch.models.common import shape_params
    from repro_torch.train.train_loop import make_train_step
    cfg = get_arch("gemma3-1b").reduced()
    model = build_model(cfg)
    ocfg = dryrun.pick_opt_cfg(cfg)
    spec_tree = model.spec_tree()
    params = shape_params(spec_tree)
    state = dryrun.opt_state_specs(ocfg, spec_tree)
    shape = dataclasses.replace(ALL_SHAPES["train_4k"], global_batch=4,
                                seq_len=32)
    batch = batch_specs(cfg, shape)
    with StepCounter() as whole:
        make_train_step(model, ocfg, num_microbatches=2, remat=True)(
            params, state, batch)
    mb = batch_specs(cfg, dataclasses.replace(shape, global_batch=2))
    with StepCounter() as one:
        one.scale = 2
        make_train_step(model, ocfg, num_microbatches=1, remat=True,
                        grad_transform=dryrun.microbatch_hook(one, 2))(
            params, state, mb)
    assert one.scale == 1
    assert one.stats.flops == whole.stats.flops > 0


# ------------------------------------------------- full width (slow)
@pytest.mark.slow
def test_dryrun_cells_trace_on_small_mesh():
    """The twin of ``tests/test_dryrun_small.py``: the three cells at
    full width on a fake (2, 4) world."""
    from repro_torch.launch.mesh import make_mesh
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        for arch, shape in REDUCED:
            rec = dryrun.run_cell(arch, shape, multi_pod=False, mesh=mesh)
            assert rec["flops_per_device"] > 0, arch
            assert rec["collective_wire_bytes"] > 0, arch


# cells beyond the gated ones that the report also holds to the reference
REPORT_ONLY = [("falcon-mamba-7b", "train_4k"),
               ("falcon-mamba-7b", "decode_32k"),
               ("jamba-1.5-large-398b", "prefill_32k")]

if __name__ == "__main__":
    # the parity report: port / reference per device, reduced cells
    cells = REDUCED + REPORT_ONLY
    got, want = _port_records(cells), _reference_records(cells)
    keys = ("dot_flops_per_device", "elementwise_flops_per_device",
            "bytes_per_device", "collective_wire_bytes")
    print("cell," + ",".join(f"{k},ref,ratio" for k in keys))
    for a, s in cells:
        g, w = got[f"{a}/{s}"], want[f"{a}/{s}"]
        print(f"{a}/{s}," + ",".join(
            f"{g[k]:.6g},{w[k]:.6g},{g[k] / w[k]:.4f}" for k in keys))
