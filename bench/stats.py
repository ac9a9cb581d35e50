"""Window statistics shared by the metric readers: every statistic is
taken over all samples of the window, none over medians of parts."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile with linear interpolation between order
    statistics (numpy's default); ``inf`` samples sort last and make the
    percentile ``inf`` when it reaches them. NaN for no samples."""
    a = sorted(float(v) for v in values)
    if not a:
        return math.nan
    pos = q / 100.0 * (len(a) - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    frac = pos - lo
    if frac == 0.0 or a[lo] == a[hi]:
        return a[lo]
    if math.isinf(a[hi]):
        return math.inf
    return a[lo] + (a[hi] - a[lo]) * frac


def tokens_in(times: Sequence[float], t_open: float, t_close: float) -> int:
    return sum(1 for t in times if t_open < t <= t_close)


def gaps_in(times: Sequence[float], t_open: float,
            t_close: float) -> List[float]:
    """Gaps between consecutive tokens of one request, both inside
    ``(t_open, t_close]``."""
    return [b - a for a, b in zip(times, times[1:])
            if t_open < a and b <= t_close]


def window_tokens(run) -> int:
    return sum(tokens_in(r.times, run.t_open, run.t_close) for r in run.recs)
