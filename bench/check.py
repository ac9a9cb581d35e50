"""Whether what the timed path served is right.

Once the window has closed and the program's state is freed, a sample of
the requests finished in the window, drawn from the seed with the
longest among them, goes through the float32 reference
(``bench/reference``): each prompt with its served tokens, teacher-forced.
For every served token the gap by which its logit lies below the
reference's best is read. Two numbers come of it, the widest gap
(``max_gap``) and the mean gap over the compared tokens (``mean_gap``);
a cell compares those its file gives a limit for. A finished request
that served another number of tokens than it asked for fails outright.

With a ``control`` the reference in lower precision stands in the
program's place: at every position of the same prompts and served
tokens, the token it puts first is read as if it had been served, and
those readings are the ones compared.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from bench.reference.model import Reference, served_gaps
from bench.traffic import sample_requests


def finished_in_window(run) -> List[Any]:
    """The requests that finished, whole, inside the window."""
    from repro_torch.serve.engine import RequestState

    out = []
    for r in run.recs:
        req = r.engine_req()
        if (req is not None and req.state is RequestState.FINISHED
                and run.t_open < req.finish_s <= run.t_close + 60.0
                and r.times and r.times[-1] > run.t_open):
            out.append(r)
    return out


def judge(run, weights, dm: Dict[str, Any], chunk: int, seed: int,
          sample: Dict[str, Any], device,
          control: Optional[str] = None) -> Dict[str, Any]:
    """Readings of the sample: ``max_gap`` and ``mean_gap`` of the
    program's served tokens, or with ``control`` of the tokens the
    control puts first at each position (the program's own readings
    then under ``program_max_gap`` and ``program_mean_gap``), the
    tokens and requests compared and the finished requests whose
    length is wrong."""
    done = finished_in_window(run)
    lengths = [len(r.engine_req().out_tokens) for r in done]
    picks = sample_requests(lengths, int(sample["served_tokens"]), seed,
                            int(sample["requests"]))
    ref = Reference(weights, dm, device)
    ctl = (Reference(weights, dm, device, control)
           if control is not None else None)
    wrong_len = sum(1 for r in done
                    if len(r.engine_req().out_tokens)
                    != r.spec.max_new_tokens)
    gaps, cgaps = [], []
    for i in picks:
        r = done[i]
        served = list(r.engine_req().out_tokens)
        gaps.append(served_gaps(ref, r.spec.prompt, served, chunk).cpu())
        if ctl is not None:
            cgaps.append(served_gaps(ref, r.spec.prompt, served, chunk,
                                     control=ctl).cpu())
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out = {"requests": len(picks), "finished": len(done),
           "wrong_length": wrong_len}
    if ctl is None:
        out.update(_readings(gaps, ""))
    else:
        out.update(_readings(cgaps, ""))
        out.update(_readings(gaps, "program_"))
    return out


def _readings(gaps, prefix: str) -> Dict[str, float]:
    """The widest gap and the mean gap over every compared token."""
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    return {prefix + "max_gap": float(g.max()) if g.numel() else 0.0,
            prefix + "mean_gap": float(g.mean()) if g.numel() else 0.0,
            prefix + "tokens": int(g.numel())}
