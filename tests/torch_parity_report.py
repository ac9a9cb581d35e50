"""Print the largest errors the port shows against the JAX package on
the CPU, one JSON line per function, at the shapes the parity tests use
(``tests/test_torch_*.py`` assert the tolerances; this reports how far
inside them the port lands). Run from the repo root:

    PYTHONPATH=src python tests/torch_parity_report.py
"""

import json
import os
import sys
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_attention as ta_test  # noqa: E402
import test_torch_paged_attention as pa_test  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.paged_attention import fused_paged_decode  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402


def err(j, t):
    return float(np.max(np.abs(np.asarray(j) - np.asarray(t))))


def main():
    rng = np.random.default_rng(0)
    rows = {}
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    s = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    rows["rmsnorm"] = err(jl.rmsnorm({"scale": jnp.asarray(s)},
                                     jnp.asarray(x)),
                          tl.rmsnorm({"scale": torch.tensor(s)},
                                     torch.tensor(x)))
    xr = rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    rows["rope"] = err(jl.rope(jnp.asarray(xr), jnp.asarray(pos), 1e6),
                       tl.rope(torch.tensor(xr), torch.tensor(pos), 1e6))
    k, v, pages, lens = ta_test._paged(9, kv=2)
    q = rng.standard_normal((4, 1, 4, 8)).astype(np.float32)
    cfg = types.SimpleNamespace(num_heads=4)
    rows["paged_decode_attention(gather)"] = err(
        ja.paged_decode_attention(
            None, cfg, *[jnp.asarray(a) for a in (q, k, v, pages, lens)],
            window=None, impl="gather"),
        tattn.paged_decode_attention(
            None, cfg, *[torch.tensor(a) for a in (q, k, v, pages, lens)],
            window=None, impl="gather"))
    worst = 0.0
    for ps in (1, 4, 16):
        for kv, g in ((8, 1), (2, 4), (1, 8)):
            arrays = pa_test._case(ps * 10 + kv, b=4, kv=kv, g=g, hd=16,
                                   ps=ps, num_pages=24, p_cap=5,
                                   dead_row=True)
            want = fused_paged_decode(*[jnp.asarray(a) for a in arrays],
                                      interpret=True)
            got = tpa.paged_decode(*[torch.tensor(a) for a in arrays])
            worst = max(worst, err(want, got))
    rows["paged_decode plain vs Pallas interpret (grid)"] = worst

    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp),
                           "cpu")
    jc = jm.init_cache(10, 4)
    tc = tm.init_cache(10, 4, "cpu")
    tbl = np.array([[3, 1, 4, 10, 10], [0, 2, 5, 10, 10]], np.int32)
    jc["pages"], tc["pages"] = jnp.asarray(tbl), torch.tensor(tbl)
    tok = rng.integers(0, 512, (2, 4)).astype(np.int32)
    qp = np.tile(np.arange(4, dtype=np.int32), (2, 1))
    jlog, jc = jm.prefill_chunk(jp, jc, jnp.asarray(tok), jnp.asarray(qp),
                                jnp.asarray(qp))
    tlog, tc = tm.prefill_chunk(tp, tc, torch.tensor(tok), torch.tensor(qp),
                                torch.tensor(qp))
    rows["LM.prefill_chunk logits"] = err(jlog, tlog)
    lens = np.array([4, 4], np.int32)
    jc["len"], tc["len"] = jnp.asarray(lens), torch.tensor(lens)
    nxt = tlog[:, -1].argmax(-1).numpy().astype(np.int32)
    worst, same = 0.0, True
    for _ in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                  attn_impl="fused")
        tlog, tc = tm.decode_step(tp, tc, torch.tensor(nxt),
                                  attn_impl="fused")
        worst = max(worst, err(jlog, tlog))
        jn = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        nxt = tlog.argmax(-1).numpy().astype(np.int32)
        same &= bool(np.array_equal(jn, nxt))
    rows["LM.decode_step logits (fused, 4 steps)"] = worst
    for name, e in rows.items():
        print(json.dumps({"function": name, "max_abs_err": e}))
    print(json.dumps({"function": "LM greedy tokens", "identical": same}))


if __name__ == "__main__":
    main()
