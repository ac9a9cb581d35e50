"""Reduce a ``torch.profiler`` trace of a run of rounds to what the
per-layer readers need: the device's busy time, each kernel's time, and
the device's idle gaps labelled by what the host was doing.

The trace is exported as Chrome JSON into the run's scratch directory,
read back and deleted. Device activity is every ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` event; the window is the span of the
harness's ``bench.round`` spans inside the trace.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime",
             "cuda_driver")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: kernel name -> summed seconds inside the window
    kernel_s: Dict[str, float]
    #: host label -> summed seconds of device idle gaps
    idle_by_host: Dict[str, float]

    def kernel_time(self, substring: str) -> float:
        return sum(s for n, s in self.kernel_s.items() if substring in n)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_labels(spans: List[Tuple[float, float, str, int]],
                 times: List[float]) -> List[str]:
    """For each time, the harness span and the innermost host op open
    then (``spans``: start, end, name, depth, sorted by start)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [""] * len(times)
    active: List[Tuple[float, float, str, int]] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] > t]
        outer = next((s[2] for s in active if s[2].startswith("bench.")),
                     None)
        inner = max((s for s in active if not s[2].startswith("bench.")),
                    key=lambda s: s[3], default=None)
        label = outer or "bench.between_rounds"
        out[i] = f"{label}/{inner[2]}" if inner else label
    return out


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    """Summary of Chrome-trace ``events`` (times in microseconds), or
    None when the trace holds no round or no device activity."""
    rounds = [e for e in events if e.get("ph") == "X"
              and e.get("name") == "bench.round"
              and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not rounds or not dev:
        return None
    w0 = min(float(e["ts"]) for e in rounds)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in rounds)
    ivs, kernel_s = [], collections.defaultdict(float)
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ivs.append((a, b))
        kernel_s[e["name"]] += (b - a) * 1e-6
    busy = _union(ivs)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # host spans, nested by start order per thread: a later start inside
    # an open span is deeper
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    spans, stack = [], []
    for a, b, name in host:
        while stack and stack[-1] <= a:
            stack.pop()
        spans.append((a, b, name, len(stack)))
        stack.append(b)
    idle = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)]
    gaps = [g for g in gaps if g[1] > g[0]]
    for (a, b), label in zip(gaps, _host_labels(
            spans, [(a + b) / 2 for a, b in gaps])):
        idle[label] += (b - a) * 1e-6
    return TraceSummary((w1 - w0) * 1e-6, busy_s, dict(kernel_s),
                        dict(idle))


def read_profiler(prof, scratch: Path) -> Optional[TraceSummary]:
    """Export ``prof``'s trace, summarize it and delete the file."""
    path = Path(scratch) / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        path.unlink(missing_ok=True)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)


def breakdown(summary: TraceSummary, n: int = 10) -> Dict[str, list]:
    """The device ops that took most time and the longest idle gaps by
    what the host was doing, ``n`` of each, in seconds."""
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:160], v] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}
