"""The yardstick's counts against hand counts at small shapes."""

import json
import math

from bench import flops, spec, weights
from bench.tests.tiny import ROOT

DENSE = dict(layers=2, d=8, heads=4, kv_heads=2, hd=2, ff=16, vocab=32,
             experts=0, top_k=0, activation="relu2", qk_norm=False,
             tied=False, dtype="bfloat16")
MOE = dict(DENSE, experts=4, top_k=2, activation="swiglu", ff=6)


def test_active_params_by_hand():
    # attention: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; relu2 FFN 2x8x16
    # = 256; per layer 448; two layers 896; head 8x32 = 256
    assert flops.active_params(DENSE) == 896 + 256
    # MoE FFN: router 8x4 + 2 experts x 3 x 8 x 6 = 32 + 288
    assert flops.active_params(MOE) == 2 * (192 + 320) + 256


def test_token_and_span_flops_by_hand():
    # 2 x 1152, plus 4 x layers 2 x heads 4 x hd 2 x context
    assert flops.token_flops(DENSE, 10) == 2 * 1152 + 4 * 2 * 4 * 2 * 10
    by_token = sum(flops.token_flops(DENSE, p + 1) for p in range(5, 13))
    assert flops.span_flops(DENSE, 5, 13) == by_token
    assert flops.span_flops(DENSE, 7, 7) == 0


def test_decode_bytes_by_hand():
    # each position: K and V of 2 kv heads x 2 dims x 2 bytes = 16;
    # each row: q and out, 4 heads x 2 dims x 2 bytes each = 32; x 2
    # layers
    assert flops.decode_bytes(DENSE, [3, 10]) == 2 * (13 * 16 + 2 * 32)
    assert flops.decode_bytes(DENSE, []) == 0


def test_weight_layout_is_the_programs():
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model_zoo import build_model

    for name in ("minitron-4b", "olmoe-1b-7b"):
        conf = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
        dm = spec.dims(conf)
        ours = {p: tuple(s) for p, (s, _, _) in weights.layout(dm).items()}
        prog = {p: tuple(s.shape) for p, s in
                tree_leaves(build_model(spec.arch_config(conf)).spec_tree())}
        assert ours == prog
        # the published totals: 4.19 B and 6.92 B weights
        n = sum(math.prod(s) for s, _, _ in weights.layout(dm).values())
        assert abs(n - {"minitron-4b": 4.19e9,
                        "olmoe-1b-7b": 6.92e9}[name]) < 0.01e9, n
