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
import test_torch_families as fam_test  # noqa: E402
import test_torch_moe as moe_test  # noqa: E402
import test_torch_paged_attention as pa_test  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.membench.ops import make_buffer as jmake_buffer  # noqa: E402,E501
from repro.kernels.membench.ops import membench as jmembench  # noqa: E402
from repro.kernels.paged_attention import fused_paged_decode  # noqa: E402
from repro.kernels.semaphore.kernel import sleeping_semaphore_pallas  # noqa: E402,E501
from repro.kernels.ticket_lock.ops import ticket_lock_run  # noqa: E402
from repro.kernels.xf_barrier.ops import xf_barrier as jxf_barrier  # noqa: E402,E501
from repro.sync import SyncLibrary as JSyncLibrary  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import membench as tmb  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import semaphore as tsem  # noqa: E402
from repro_torch.kernels import ticket_lock as ttl  # noqa: E402
from repro_torch.kernels import xf_barrier as txb  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.sync import SyncLibrary  # noqa: E402


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
    worst = worst_split = 0.0
    for ps in (1, 4, 16):
        for kv, g in ((8, 1), (2, 4), (1, 8), (8, 5)):
            arrays = pa_test._case(ps * 10 + kv, b=4, kv=kv, g=g, hd=16,
                                   ps=ps, num_pages=24, p_cap=5,
                                   dead_row=True)
            want = fused_paged_decode(*[jnp.asarray(a) for a in arrays],
                                      interpret=True)
            got = tpa.paged_decode(*[torch.tensor(a) for a in arrays])
            worst = max(worst, err(want, got))
            for pps in (5, 3, 2, 1):          # 1, 2, 3 and 5 splits
                got = tpa.paged_decode_split_model(
                    *[torch.tensor(a) for a in arrays], pages_per_split=pps)
                worst_split = max(worst_split, err(want, got))
    rows["paged_decode plain vs Pallas interpret (grid)"] = worst
    rows["paged_decode split model vs Pallas interpret (grid, 1-5 "
         "splits)"] = worst_split
    worst = worst_split = 0.0
    for window in (None, 5, 12):
        arrays = pa_test._case(25, b=4, kv=1, g=4, hd=256, ps=4,
                               num_pages=24, p_cap=6, dead_row=True)
        want = fused_paged_decode(*[jnp.asarray(a) for a in arrays],
                                  window=window, interpret=True)
        t = [torch.tensor(a) for a in arrays]
        worst = max(worst, err(want, tpa.paged_decode(*t, window=window)))
        for pps in (6, 3, 2, 1):
            got = tpa.paged_decode_split_model(*t, pages_per_split=pps,
                                               window=window)
            worst_split = max(worst_split, err(want, got))
    rows["paged_decode plain vs Pallas interpret (hd 256, KV 1, G 4, "
         "windows)"] = worst
    rows["paged_decode split model vs Pallas interpret (hd 256, 1-6 "
         "splits)"] = worst_split

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
    rows.update(sync_rows())
    slot_rows, streams = slots_rows(jm, jp, tm, tp)
    rows.update(slot_rows)
    pre_rows, pre_streams = prefix_rows(jm, jp, tm, tp)
    rows.update(pre_rows)
    streams.update(pre_streams)
    rows.update(moe_rows())
    fam_rows, fam_streams = family_rows()
    rows.update(fam_rows)
    streams.update(fam_streams)
    for name, e in rows.items():
        print(json.dumps({"function": name, "max_abs_err": e}))
    print(json.dumps({"function": "LM greedy tokens", "identical": same}))
    for name, same in streams.items():
        print(json.dumps({"function": name, "identical": same}))


def moe_rows():
    """``route`` and the two MoE dispatches at E 64 / k 8, d 128, with
    drops and forced ties (tests/test_torch_moe.py's inputs)."""
    rows = {}
    e, k = 64, 8
    x, r = moe_test._x(e + k, True), moe_test._router(e + k, e, True)
    cap = moe_test._cap(e, k, True)
    jd, jc, ja_ = jmoe.route(jnp.asarray(x), jnp.asarray(r), e, k, cap)
    td, tc, ta_ = tmoe.route(torch.tensor(x), torch.tensor(r), e, k, cap)
    rows["moe.route dispatch / combine / aux (E 64, k 8, drops, ties)"] = \
        max(err(jd, td), err(jc, tc),
            *(abs(float(ja_[n]) - float(ta_[n])) for n in ja_))
    jcfg, tcfg = moe_test._cfgs(e, k)
    p = moe_test._params(e + k, e)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.tensor(a) for n, a in p.items()}
    x = moe_test._x(3 * e + k)
    j_ein = jmoe.moe_ffn_einsum(jp, jnp.asarray(x), jcfg)[0]
    j_gat = jmoe.moe_ffn_gather(jp, jnp.asarray(x), jcfg)[0]
    t_ein = tmoe.moe_ffn_einsum(tp, torch.tensor(x), tcfg)[0]
    t_gat = tmoe.moe_ffn_gather(tp, torch.tensor(x), tcfg)[0]
    rows["moe_ffn_einsum vs JAX (E 64, k 8)"] = err(j_ein, t_ein)
    rows["moe_ffn_gather vs JAX (E 64, k 8)"] = err(j_gat, t_gat)
    rows["moe_ffn_gather vs moe_ffn_einsum (port)"] = err(t_ein, t_gat)
    return rows


def family_rows():
    """Each reduced family of tests/test_torch_families.py: ``forward``
    logits (absolute, and over the reference's largest |logit|) and MoE
    aux; four greedy fused ``decode_step`` calls on a paged cache after
    a prefill chunk of 8."""
    rows, streams = {}, {}
    for name in fam_test.FAMILIES:
        jm, jp, tm, tp = fam_test.models(name)
        tok = fam_test._tokens(1, 2, 20)
        jl_, ja_ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
        tl_, ta_ = tm.forward(tp, {"tokens": torch.tensor(tok)})
        e = err(jl_, tl_)
        rows[f"{name} LM.forward logits (abs; rel. to max |logit|)"] = [
            e, e / float(np.abs(np.asarray(jl_)).max())]
        if ja_:
            rows[f"{name} LM.forward MoE aux"] = max(
                abs(float(ja_[n]) - float(ta_[n])) for n in ja_)
        jc, tc = jm.init_cache(16, 4), tm.init_cache(16, 4, "cpu")
        tbl = np.array([[3, 1, 4, 9, 12, 16], [0, 2, 5, 7, 16, 16]],
                       np.int32)
        jc["pages"], tc["pages"] = jnp.asarray(tbl), torch.tensor(tbl)
        tok = fam_test._tokens(3, 2, 8)
        qp = np.tile(np.arange(8, dtype=np.int32), (2, 1))
        jlog, jc = jm.prefill_chunk(jp, jc, *map(jnp.asarray, (tok, qp, qp)))
        tlog, tc = tm.prefill_chunk(tp, tc, *map(torch.tensor, (tok, qp, qp)))
        jc["len"] = jnp.asarray([8, 8], jnp.int32)
        tc["len"] = torch.tensor([8, 8], dtype=torch.int32)
        nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
        worst, same = 0.0, True
        for _ in range(4):
            jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                      attn_impl="fused")
            tlog, tc = tm.decode_step(tp, tc, torch.tensor(nxt),
                                      attn_impl="fused")
            worst = max(worst, err(jlog, tlog))
            nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
            same &= bool(np.array_equal(nxt, tlog.argmax(-1).numpy()))
        rows[f"{name} LM.decode_step logits (paged fused, 4 steps)"] = worst
        streams[f"{name} greedy decode tokens"] = same
    return rows, streams


def slots_rows(jm, jp, tm, tp):
    """One-shot prefill, the contiguous cache and the default serving
    path (tests/test_torch_prefill.py, tests/test_torch_slots.py)."""
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro.serve.engine import SlotServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine, SlotServeEngine
    rng = np.random.default_rng(7)
    rows = {}
    q, k, v = (rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
               for _ in range(3))
    rows["blocked_attention (causal, window 5, 3 x 6 blocks)"] = err(
        ja.blocked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                             window=5, q_chunk=8, kv_chunk=4),
        tattn.blocked_attention(*map(torch.tensor, (q, k, v)), causal=True,
                                window=5, q_chunk=8, kv_chunk=4))
    rows["full_attention (causal, one block)"] = err(
        ja.full_attention(None, jm.cfg, *map(jnp.asarray, (q, k, v)),
                          causal=True, window=None),
        tattn.full_attention(None, tm.cfg, *map(torch.tensor, (q, k, v)),
                             causal=True, window=None))
    tok = rng.integers(0, 512, (3, 13)).astype(np.int32)
    rows["LM.forward logits"] = err(
        jm.forward(jp, {"tokens": jnp.asarray(tok)})[0],
        tm.forward(tp, {"tokens": torch.tensor(tok)})[0])
    length = np.array([13, 6, 1], np.int32)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, max_len=16,
                          length=jnp.asarray(length))
    tlog, tc = tm.prefill(tp, {"tokens": torch.tensor(tok)}, max_len=16,
                          length=torch.tensor(length))
    rows["LM.prefill logits (length=)"] = err(jlog, tlog)
    rows["LM.prefill cache (length=)"] = max(
        err(jc["periods"]["layer_0"][n], tc["periods"]["layer_0"][n])
        for n in ("k", "v"))
    nxt = tlog.argmax(-1).numpy().astype(np.int32)
    worst = 0.0
    for _ in range(4):        # row 0 reaches max_len 16 and drops
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tlog, tc = tm.decode_step(tp, tc, torch.tensor(nxt))
        worst = max(worst, err(jlog, tlog))
        nxt = tlog.argmax(-1).numpy().astype(np.int32)
    rows["LM.decode_step logits (contiguous, per-row len, 4 steps)"] = worst
    arr = np.sort(rng.uniform(0.0, 0.5, 2100)).astype(np.float32)
    hold = rng.integers(1, 9, 2100).astype(np.float32)
    want = JSyncLibrary.host_default().plan_semaphore(arr, hold, 2048,
                                                      backend="ref")
    got = SyncLibrary.host_default().plan_semaphore(arr, hold, 2048,
                                                    backend="ref")
    rows["plan_semaphore ref K 2048 vs JAX ref (grant, release, waited)"] = \
        max(err(want.grant, got.grant), err(want.release, got.release),
            err(want.waited, got.waited))
    streams = {}
    reqs = [(rng.integers(0, 512, int(rng.integers(3, 15))).astype(
        np.int32), int(rng.integers(2, 7))) for _ in range(7)]
    for name, kw in (
            ("slots one-shot", dict(kv_layout="slots", decode_chunk=2)),
            ("slots chunked", dict(kv_layout="slots", decode_chunk=2,
                                   prefill_chunk_tokens=4)),
            ("paged one-shot eager", dict(kv_layout="paged", page_size=4,
                                          page_growth="eager",
                                          prefix_sharing="off"))):
        out = []
        for cls, m, prm, extra in ((JEngine, jm, jp, {}),
                                   (SlotServeEngine, tm, tp,
                                    {"device": "cpu"})):
            eng = cls(m, prm, capacity=3, max_len=32, **kw, **extra)
            hs = [eng.submit(p, n) for p, n in reqs]
            eng.run_until_done()
            out.append(([h.out_tokens for h in hs], eng.grant_log))
        streams[f"SlotServeEngine {name}: streams, grant_log"] = \
            out[0] == out[1]
    tok = rng.integers(0, 512, (2, 7)).astype(np.int32)
    streams["ServeEngine (legacy) tokens"] = (
        np.asarray(JServeEngine(jm, jp, max_len=16).generate(
            {"tokens": jnp.asarray(tok)}, 6).tokens).tolist()
        == ServeEngine(tm, tp, max_len=16).generate(
            {"tokens": torch.tensor(tok)}, 6).tokens.tolist())
    return rows, streams


def prefix_rows(jm, jp, tm, tp):
    """Prefix sharing, the CoW copy and the prefix cache
    (tests/test_torch_prefix_sharing.py, tests/test_torch_prefix_cache.py):
    the copy's error, whether the index and cache keys and lookups are
    identical, and whether the engines' streams, grant logs, acquires
    and sharing / cache statistics are."""
    from repro.serve import kv_pages as jkv
    from repro.serve import prefix_cache as jpc
    from repro.serve.engine import SlotServeEngine as JEngine
    from repro_torch.serve import kv_pages as tkv
    from repro_torch.serve import prefix_cache as tpc
    from repro_torch.serve.engine import SlotServeEngine
    rng = np.random.default_rng(11)
    rows, same = {}, {}
    arena = rng.standard_normal((3, 9, 4, 2, 8)).astype(np.float32)
    src, dst = np.array([0, 5, 7], np.int32), np.array([2, 9, 4], np.int32)
    rows["copy_pages (period-stacked, a sentinel target)"] = err(
        ja.copy_pages(jnp.asarray(arena), jnp.asarray(src), jnp.asarray(dst),
                      axis=1),
        tattn.copy_pages(torch.from_numpy(arena.copy()), src, dst, axis=1))
    toks = rng.integers(0, 512, 22).astype(np.int32)
    found = []
    for kv, pc in ((jkv, jpc), (tkv, tpc)):
        pool = kv.PagePool(16, 4)
        idx, cache = kv.PrefixIndex(4, pool), pc.PrefixCache(4, pool)
        ids = pool.alloc(6, tag="donor")
        idx.register(toks, 32, ids)
        cache.donate(toks, pool.alloc(5, tag="retiree"),
                     pc.cache_key_suffix(0, 4), generated_from=16)
        found.append((sorted(idx._entries),
                      [idx.lookup(toks[:n], 32)[0] for n in (22, 13, 8, 3)],
                      cache.lookup(toks, pc.cache_key_suffix(0, 4))[0],
                      cache.holders(), cache.evict_plan(3)[1]))
    same["PrefixIndex keys and lookups, PrefixCache lookup / holders / "
         "evict_plan"] = found[0] == found[1]
    prompt = rng.integers(1, 512, 10).astype(np.int32)
    for name, kw in (("sharing one-shot", dict(prefix_sharing="on")),
                     ("sharing chunked", dict(prefix_sharing="on",
                                              prefill_chunk_tokens=4)),
                     ("cache chunked", dict(prefix_cache="on",
                                            prefill_chunk_tokens=4))):
        out = []
        for cls, m, prm, extra in ((JEngine, jm, jp, {"seed": 0}),
                                   (SlotServeEngine, tm, tp,
                                    {"device": "cpu"})):
            eng = cls(m, prm, capacity=3, max_len=32, kv_layout="paged",
                      page_size=4, decode_chunk=2, **kw, **extra)
            hs = [eng.submit(prompt, 6)]
            for _ in range(3):
                eng.step()
            hs += [eng.submit(prompt, 4), eng.submit(prompt[:9], 4)]
            eng.run_until_done()
            hs.append(eng.submit(prompt, 4))
            eng.run_until_done()
            st = eng.stats()
            out.append(([h.out_tokens for h in hs], eng.grant_log,
                         eng.pool.pages.lock_stats()["acquires"],
                         {k: v for k, v in st.items()
                          if k.startswith(("prefix", "cache_"))
                          or k in ("shared_pages_adopted", "cow_splits")}))
        same[f"SlotServeEngine {name}: streams, grant_log, acquires, "
             f"sharing / cache stats"] = out[0] == out[1]
    return rows, same


def sync_rows():
    """The slice-2 kernels and plan forms: the plain versions against the
    Pallas kernels (interpret mode), the port's host and ref plans
    against the JAX library's kernel plans, over seeded traces."""
    rows = {}
    worst_acc, worst_int = 0.0, 0.0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 60))
        arr = rng.permutation(n).astype(np.int32)
        m = rng.uniform(0.5, 1.5, n).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        want = ticket_lock_run(jnp.asarray(arr), jnp.asarray(m),
                               jnp.asarray(b), interpret=True)
        got = ttl.ticket_lock(*(torch.tensor(x) for x in (arr, m, b)))
        worst_int = max(worst_int, err(want[0], got[0]), err(want[1], got[1]))
        worst_acc = max(worst_acc, err(want[2], got[2]))
    rows["ticket_lock plain vs Pallas interpret: grant, trace"] = worst_int
    rows["ticket_lock plain vs Pallas interpret: acc"] = worst_acc
    worst_acc, worst_int = 0.0, 0.0
    for seed, slots in ((0, 1), (1, 3), (2, 32), (3, 7)):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 60))
        arr = rng.permutation(n).astype(np.int32)
        m = rng.uniform(0.5, 1.5, n).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        want = ticket_lock_run(jnp.asarray(arr), jnp.asarray(m),
                               jnp.asarray(b), interpret=True)
        got = ttl.ticket_lock_schedule_model(arr, m, b, slots, seed=seed)
        worst_int = max(worst_int, err(want[0], got[0]), err(want[1], got[1]))
        worst_acc = max(worst_acc, err(want[2], got[2]))
    rows["ticket_lock schedule model vs Pallas interpret: grant, trace"] = \
        worst_int
    rows["ticket_lock schedule model vs Pallas interpret: acc"] = worst_acc
    worst = 0.0
    for seed, cap in ((0, 4), (1, 9), (2, 33), (3, 1024)):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 60))
        arrive = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
        hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
        want = sleeping_semaphore_pallas(jnp.asarray(arrive),
                                         jnp.asarray(hold), cap,
                                         interpret=True)
        got = tsem.semaphore_admission_model(arrive, hold, cap)
        worst = max(worst, *(err(w, g) for w, g in zip(want, got)))
    rows["semaphore_admission model vs Pallas interpret (K 4, 9, 33, "
         "1024)"] = worst
    worst = worst_model = 0.0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 200))
        arrive = rng.integers(0, 4, n).astype(np.int32)
        present = (rng.uniform(size=n) < 0.85).astype(np.int32)
        required = (rng.uniform(size=n) < 0.8).astype(np.int32)
        want = jxf_barrier(jnp.asarray(arrive), jnp.int32(2),
                           jnp.asarray(present),
                           jnp.asarray(required), interpret=True)
        got = txb.xf_barrier(torch.tensor(arrive), 2, torch.tensor(present),
                             torch.tensor(required))
        worst = max(worst, *(err(w, g) for w, g in zip(want, got)))
        for max_polls in (0, 1):
            model = txb.xf_barrier_schedule_model(
                arrive, 2, present, required, slots=32,
                max_polls=max_polls, seed=seed)
            worst_model = max(worst_model, *(err(w, g) for w, g in zip(
                want, model)))
    rows["xf_barrier plain vs Pallas interpret (all outputs)"] = worst
    rows["xf_barrier schedule model (budget 0, 1) vs Pallas interpret"] = \
        worst_model
    worst = 0.0
    for cont in (True, False):
        for wr in (True, False):
            jbuf = jmake_buffer(16)
            want = jmembench(jbuf, n_steps=16, contentious=cont, write=wr,
                             repeats=8)
            got = tmb.membench(torch.tensor(np.asarray(jbuf)), n_steps=16,
                               contentious=cont, write=wr, repeats=8)
            worst = max(worst, err(want[0], got[0]), float(np.max(
                np.abs(np.asarray(want[1]) - got[1].numpy())
                / np.abs(np.asarray(want[1])))))
    rows["membench plain vs Pallas interpret (buffer abs, sums rel)"] = worst
    lib, jlib = SyncLibrary.host_default(), JSyncLibrary.host_default()
    acc = barrier = bounded = 0.0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 11))
        arr = rng.permutation(n).astype(np.int32)
        want = jlib.plan_mutex(arr, backend="kernel")
        for be in ("host", "ref"):
            acc = max(acc, abs(lib.plan_mutex(arr, backend=be).acc
                               - want.acc), err(
                lib.plan_mutex(arr, backend=be).grant_order,
                want.grant_order))
        present = (rng.uniform(size=n) < 0.8).astype(np.int64)
        jb = jlib.plan_barrier(present, backend="kernel")
        for be in ("host", "ref"):
            pb = lib.plan_barrier(present, backend=be)
            barrier = max(barrier, err(pb.released, jb.released),
                          err(pb.stragglers, jb.stragglers),
                          abs(pb.done - jb.done))
        arrivals = np.sort(rng.uniform(0, 2, n)).astype(np.float32)
        holds = rng.uniform(0.5, 1.5, n).astype(np.float32)
        timeouts = rng.choice([0.0, 0.7, 2.5, np.inf], size=n).astype(
            np.float32)
        jm = jlib.plan_mutex_bounded(arrivals, holds, timeouts,
                                     backend="kernel")
        for be in ("host", "ref"):
            pm = lib.plan_mutex_bounded(arrivals, holds, timeouts,
                                        backend=be)
            bounded = max(bounded, err(pm.grant, jm.grant),
                          err(pm.granted.astype(int),
                              jm.granted.astype(int)))
    rows["plan_mutex host/ref vs JAX kernel (grant order, acc)"] = acc
    rows["plan_barrier host/ref vs JAX kernel (done, released, "
         "stragglers)"] = barrier
    rows["plan_mutex_bounded host/ref vs JAX kernel (grant, granted)"] = \
        bounded
    return rows


if __name__ == "__main__":
    main()
