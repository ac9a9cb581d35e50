"""The port's roofline model against the JAX package's: the three terms,
the bottleneck and the MFU bound on the H100 constants (the twin of
``tests/test_roofline.py``), the record's keys, and the parameter and
model-flops counts of every architecture at every shape."""

import pytest

from repro.analysis import roofline as jrl
from repro.configs import ARCHS as J_ARCHS
from repro.configs import ALL_SHAPES as J_SHAPES
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Roofline, model_flops)
from repro_torch.configs import ALL_SHAPES, ARCHS
from repro_torch.configs.shapes import DECODE_32K, PREFILL_32K, TRAIN_4K


def test_h100_constants():
    assert PEAK_FLOPS == 989e12
    assert HBM_BW == 3.35e12
    assert LINK_BW == 450e9


def _cell(mod):
    return mod.Roofline(
        arch="a", shape="train_4k", mesh="16x16", chips=256,
        flops_per_device=mod.PEAK_FLOPS,           # 1 s of compute
        bytes_per_device=mod.HBM_BW * 2,           # 2 s of memory
        collective_wire_bytes=mod.LINK_BW * 0.5,   # 0.5 s of comms
        collectives={},
        model_flops_total=mod.PEAK_FLOPS * 256 * 0.5,
    )


def test_roofline_terms_and_bottleneck():
    r = _cell(rl)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 2.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9
    assert r.bottleneck == "memory"
    assert abs(r.step_time_lower_bound - 2.0) < 1e-9
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    assert abs(r.mfu_bound - 0.25) < 1e-9


def test_to_json_keys_and_unitless_values_match_the_reference():
    got, want = _cell(rl).to_json(), _cell(jrl).to_json()
    assert list(got) == list(want)
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
              "useful_flops_ratio", "mfu_bound", "chips"):
        assert got[k] == pytest.approx(want[k]), k


def test_model_flops_modes():
    class C:
        moe = None

    n = 1e9
    assert model_flops(C(), TRAIN_4K, n) == 6 * n * TRAIN_4K.tokens
    assert model_flops(C(), PREFILL_32K, n) == 2 * n * PREFILL_32K.tokens
    assert model_flops(C(), DECODE_32K, n) == 2 * n * DECODE_32K.global_batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_and_model_flops_match_the_reference(arch):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    got = rl.count_total_and_active_params(cfg)
    want = jrl.count_total_and_active_params(jcfg)
    assert got == want
    for name in ALL_SHAPES:
        assert rl.model_flops(cfg, ALL_SHAPES[name], *got) == \
            jrl.model_flops(jcfg, J_SHAPES[name], *want), name
