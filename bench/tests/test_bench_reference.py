"""The float32 reference against the port at a reduced size, on the
same weights (float32, so the two differ by rounding alone)."""

import torch

from bench import spec, weights
from bench.reference.model import Reference, served_gaps
from bench.tests.tiny import tiny_configs


def _pair(kind):
    from repro_torch.models.model_zoo import build_model

    conf = tiny_configs("float32")[kind]
    dm = spec.dims(conf)
    return dm, build_model(spec.arch_config(conf)), weights.make(dm, 4, "cpu")


def _close(a, b, tol=1e-4):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_dense_reference_matches_the_forward():
    dm, model, w = _pair("dense")
    ids = torch.randint(0, dm["vocab"], (1, 40), generator=torch.Generator()
                        .manual_seed(0))
    want, _ = model.forward(w, {"tokens": ids})
    ref = Reference(w, dm, "cpu")
    hid = ref.hidden(ids[0], 40, 8)
    got = torch.cat([b for _, b in ref.logit_blocks(hid)])
    assert _close(got, want[0])


def test_moe_reference_matches_one_call():
    # the whole sequence as one call of the MoE (the forward's routing):
    # a single prompt chunk as wide as the sequence
    dm, model, w = _pair("moe")
    ids = torch.randint(0, dm["vocab"], (1, 24), generator=torch.Generator()
                        .manual_seed(1))
    want, aux = model.forward(w, {"tokens": ids})
    assert float(aux["moe_drop_frac"]) > 0      # drops happen and agree
    ref = Reference(w, dm, "cpu")
    got = torch.cat([b for _, b in ref.logit_blocks(ref.hidden(ids[0], 24,
                                                               24))])
    assert _close(got, want[0])


def test_moe_chunks_route_apart():
    # chunked prefill routes each chunk on its own: the reference's
    # chunking changes the drops and so the logits
    dm, _, w = _pair("moe")
    ids = torch.randint(0, dm["vocab"], (24,), generator=torch.Generator()
                        .manual_seed(1))
    ref = Reference(w, dm, "cpu")
    assert not torch.allclose(ref.hidden(ids, 24, 24), ref.hidden(ids, 24, 8))


def test_gaps_are_zero_on_the_references_own_tokens():
    dm, _, w = _pair("dense")
    ref = Reference(w, dm, "cpu")
    prompt = torch.arange(10) % dm["vocab"]
    served = []
    seq = prompt.clone()
    for _ in range(6):
        hid = ref.hidden(seq, seq.numel(), 8)
        nxt = int(next(ref.logit_blocks(hid[-1:]))[1].argmax())
        served.append(nxt)
        seq = torch.cat([seq, torch.tensor([nxt])])
    assert float(served_gaps(ref, prompt, served, 8).max()) == 0.0
    bad = list(served)
    bad[3] = (bad[3] + 1) % dm["vocab"]
    assert float(served_gaps(ref, prompt, bad, 8).max()) > 0.0
