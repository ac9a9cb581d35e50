"""The asyncio streaming front-end in the port, held to the JAX package's
(the reference's tests/test_frontend.py front-end half and the front-end
cases of tests/test_faults.py): each scenario runs through
``repro.serve.AsyncFrontend`` over the JAX engine and through the port's
over its engine, and the handles' streams and states, the front-end's
counters (shed, rounds, executor deaths survived), the engine's
``grant_log`` and its lifecycle counts must be equal —

* streams across rounds equal to the closed-loop engine's;
* a mid-stream cancel from a ``round_hook`` (deterministic: the hook runs
  between rounds) reclaims the victim and spares the survivor;
* the intake bound sheds a burst (``IntakeFullError``);
* a cancel while still in intake never reaches the engine;
* a step deadline expires a queued request;
* injected executor deaths are survived by retrying the round;
* a quarantined request delivers its partial stream, then raises
  ``RequestFailedError``.

Reduced qwen3-14b, float32, the reference's weights through the bridge."""

import asyncio
import types

import jax
import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy

COUNTS = ("finished", "terminal", "cancelled", "expired", "failed",
          "faults_injected", "rounds_retried", "requests_quarantined",
          "tokens", "decode_dispatches", "frontend_shed", "frontend_rounds",
          "frontend_pending", "frontend_live", "frontend_executor_faults")


@pytest.fixture(scope="module")
def stacks():
    """The JAX package and the port, each with its model and weights."""
    jm = jbuild(jget_arch("qwen3-14b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_arch("qwen3-14b").reduced())
    tp = params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (types.SimpleNamespace(pkg=jserve, model=jm, params=jp,
                                  extra={"seed": 0}),
            types.SimpleNamespace(pkg=tserve, model=tm, params=tp,
                                  extra={"device": "cpu"}))


def _prompts(lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _engine(st, prompts, new_tokens, *, capacity=2, chunk=6, **kw):
    max_len = max(len(p) for p in prompts) + new_tokens + 1
    return st.pkg.SlotServeEngine(
        st.model, st.params, capacity=capacity, max_len=max_len,
        decode_chunk=2, kv_layout="paged", page_size=8,
        prefix_sharing="off", prefill_chunk_tokens=chunk, **kw, **st.extra)


def _record(fe, handles, streams):
    eng = fe.engine
    st = fe.stats()
    eng.pool.pages.check()
    assert eng.pool.pages.n_free == eng.pool.pages.num_pages
    return {"streams": streams,
            "states": [h.state.value for h in handles],
            "handle_tokens": [h.out_tokens for h in handles],
            "grant_log": list(eng.grant_log),
            **{k: st[k] for k in COUNTS}}


def _both(stacks, scenario):
    """Run ``scenario(stack) -> record`` on the JAX stack and the port's;
    the records must be equal. Returns the port's."""
    want, got = (scenario(st) for st in stacks)
    assert got == want
    return got


def test_streams_across_rounds_match_the_engine(stacks):
    prompts = _prompts([12, 5, 9])
    new = 6
    port = stacks[1]
    eng = _engine(port, prompts, new)
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run_until_done()
    closed = [list(r.out_tokens) for r in reqs]

    def scenario(st):
        async def main():
            async with st.pkg.AsyncFrontend(_engine(st, prompts, new),
                                            intake_limit=8) as fe:
                hs = [await fe.submit(p, new) for p in prompts]
                streams = [await h.collect() for h in hs]
                await fe.drain()
            for h in hs:
                assert h.done and h.ttft_s is not None and h.ttft_s >= 0
            return _record(fe, hs, streams)
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["streams"] == closed
    assert got["frontend_rounds"] >= 2 and got["frontend_shed"] == 0


def test_mid_stream_cancel_from_round_hook(stacks):
    prompts = _prompts([12, 5])

    def scenario(st):
        state = {}

        async def hook(fe):
            h = state.get("victim")
            if h is not None and h._streamed >= 2 \
                    and not h._cancel_requested:
                h.cancel()

        async def main():
            async with st.pkg.AsyncFrontend(_engine(st, prompts, 24),
                                            intake_limit=8,
                                            round_hook=hook) as fe:
                survivor = await fe.submit(prompts[0], 6)
                victim = await fe.submit(prompts[1], 24)
                state["victim"] = victim
                got_s = await survivor.collect()
                got_v = [t async for t in victim]
                await fe.drain()
            assert victim.out_tokens == got_v       # froze at the cancel
            return _record(fe, [survivor, victim], [got_s, got_v])
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["states"] == ["finished", "cancelled"]
    assert 2 <= len(got["streams"][1]) < 24 and got["cancelled"] == 1


def test_intake_bound_sheds_a_burst(stacks):
    prompts = _prompts([8])

    def scenario(st):
        async def main():
            fe = st.pkg.AsyncFrontend(_engine(st, prompts, 4, capacity=1),
                                      intake_limit=2)
            shed = []
            async with fe:
                first = await fe.submit(prompts[0], 4)
                second = await fe.submit(prompts[0], 4)
                try:
                    for _ in range(50):
                        await fe.submit(prompts[0], 4)
                except st.pkg.IntakeFullError as e:
                    shed.append(str(e))
                streams = [await first.collect(), await second.collect()]
                await fe.drain()
            return {**_record(fe, [first, second], streams), "shed": shed}
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["frontend_shed"] == 1 and len(got["shed"]) == 1
    assert got["states"] == ["finished", "finished"]
    assert got["grant_log"] == sorted(got["grant_log"])


def test_cancel_in_intake_never_reaches_the_engine(stacks):
    prompts = _prompts([8, 8])

    def scenario(st):
        async def main():
            async with st.pkg.AsyncFrontend(_engine(st, prompts, 4),
                                            intake_limit=8) as fe:
                keep = await fe.submit(prompts[0], 4)
                drop = await fe.submit(prompts[1], 4)
                drop.cancel()
                toks = await keep.collect()
                dropped = [t async for t in drop]
                await fe.drain()
            assert drop.req is None
            return _record(fe, [keep, drop], [toks, dropped])
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["states"] == ["finished", "cancelled"]
    assert got["streams"][1] == [] and got["grant_log"] == [0]


def test_step_deadline_expires_a_queued_request(stacks):
    prompts = _prompts([10, 10])

    def scenario(st):
        async def main():
            eng = _engine(st, prompts, 8, capacity=1, chunk=None)
            async with st.pkg.AsyncFrontend(eng, intake_limit=8) as fe:
                blocker = await fe.submit(prompts[0], 8)
                doomed = await fe.submit(prompts[1], 8, deadline_steps=1)
                streams = [await blocker.collect(), await doomed.collect()]
                await fe.drain()
            return _record(fe, [blocker, doomed], streams)
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["states"] == ["finished", "expired"]
    assert len(got["streams"][0]) == 8 and got["streams"][1] == []
    assert got["expired"] == 1


def test_executor_death_is_survived(stacks):
    """Deaths injected before the step starts: the round is retried and
    every stream completes; the same deaths in both packages."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, 5).astype(np.int32) for _ in range(4)]

    def scenario(st):
        fp = st.pkg.FaultPlan(3, executor_rate=0.25)

        async def main():
            eng = st.pkg.SlotServeEngine(
                st.model, st.params, capacity=2, max_len=64,
                kv_layout="paged", page_size=4, decode_chunk=2,
                fault_plan=fp, **st.extra)
            async with st.pkg.AsyncFrontend(eng) as fe:
                hs = [await fe.submit(p, 4) for p in prompts]
                outs = [await h.collect() for h in hs]
            return {**_record(fe, hs, outs), "plan": fp.stats()}
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["frontend_executor_faults"] > 0
    assert got["plan"]["faults_by_kind"]["executor"] == \
        got["frontend_executor_faults"]
    assert all(len(o) == 4 for o in got["streams"])


def test_quarantine_surfaces_as_request_failed(stacks):
    """A quarantined request's handle delivers its partial stream, then
    raises ``RequestFailedError``; the concurrent handle completes."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, 5).astype(np.int32) for _ in range(2)]

    def scenario(st):
        fp = st.pkg.FaultPlan(0, poison_rid=1)

        async def main():
            eng = st.pkg.SlotServeEngine(
                st.model, st.params, capacity=2, max_len=64,
                kv_layout="paged", page_size=4, decode_chunk=2,
                fault_plan=fp, quarantine_after=2, retry_backoff_s=0.0,
                **st.extra)
            async with st.pkg.AsyncFrontend(eng) as fe:
                h0 = await fe.submit(prompts[0], 4)
                h1 = await fe.submit(prompts[1], 4)
                out0 = await h0.collect()
                partial = []
                with pytest.raises(st.pkg.RequestFailedError) as ei:
                    async for t in h1:
                        partial.append(t)
            assert h1.error == str(ei.value)
            return {**_record(fe, [h0, h1], [out0, partial]),
                    "error": str(ei.value)}
        return asyncio.run(main())
    got = _both(stacks, scenario)
    assert got["states"] == ["finished", "failed"]
    assert "injected fault" in got["error"]
    assert len(got["streams"][0]) == 4 and got["requests_quarantined"] == 1


def test_submit_before_start_raises():
    """The front-end must be running to take a submission (both
    packages raise the same error)."""
    async def main(pkg):
        fe = pkg.AsyncFrontend(object.__new__(pkg.SlotServeEngine))
        with pytest.raises(RuntimeError, match="not running"):
            await fe.submit(np.arange(3), 2)
        with pytest.raises(ValueError, match="intake_limit"):
            pkg.AsyncFrontend(object.__new__(pkg.SlotServeEngine),
                              intake_limit=0)
    for pkg in (jserve, tserve):
        asyncio.run(main(pkg))
