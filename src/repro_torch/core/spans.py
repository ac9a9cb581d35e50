"""The port's tracing: named ranges on the ``torch.profiler`` timeline and
the serving engine's phase clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records on this thread, and one shared no-op context otherwise:
no switch and no environment variable, one flag test a site. Names carry
their layer (``serve.``, ``model.``); none starts with ``bench.``, the
benchmark harness's own prefix.

:class:`PhaseClock` is always on. It tiles a caller's work into named
host phases on ``time.perf_counter`` (``switch`` closes one phase and
opens the next, so the phases add up to the wall time from ``begin`` to
``end``) and, while profiling, opens a range for each phase. It also
times named device spans between marks: on a card with reusable CUDA
events, read once the caller has synchronised past the last mark;
elsewhere, where the work runs synchronously, on the host clock at the
same marks. A device span runs from its first mark to its last, so it
includes the gaps in which the device waits for the host's launches.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records on this
    thread, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class PhaseClock:
    """Cumulative host seconds per phase (``host_s``) and device-clock
    seconds per device span (``device_s``). ``device_spans`` maps a span
    to its ``(start mark, end mark)``; phase ranges are named ``prefix +
    phase``."""

    def __init__(self, device, phases: Sequence[str],
                 device_spans: Dict[str, Tuple[str, str]], prefix: str):
        self.host_s: Dict[str, float] = dict.fromkeys(phases, 0.0)
        self.device_s: Dict[str, float] = dict.fromkeys(device_spans, 0.0)
        self._spans = dict(device_spans)
        self._prefix = prefix
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._events: Dict[str, torch.cuda.Event] = {}
        self._marks: Dict[str, object] = {}
        self._stream = None
        self._phase: Optional[str] = None
        self._t = 0.0
        self._range = None

    # ------------------------------------------------------- host phases
    def begin(self, phase: str) -> None:
        self._phase, self._t = phase, time.perf_counter()
        self._open()

    def switch(self, phase: str) -> None:
        t = time.perf_counter()
        self.host_s[self._phase] += t - self._t
        self._t = t
        self._close()
        self._phase = phase
        self._open()

    def end(self) -> None:
        self.host_s[self._phase] += time.perf_counter() - self._t
        self._close()
        self._phase = None

    def _open(self) -> None:
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(
                self._prefix + self._phase)
            self._range.__enter__()

    def _close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    # ------------------------------------------------------ device spans
    def start_marks(self) -> None:
        """Drop the marks of an attempt that was never read; the next
        marks go on the device's current stream."""
        self._marks.clear()
        if self._cuda:
            self._stream = torch.cuda.current_stream(self._device)

    def mark(self, key: str) -> None:
        if not self._cuda:
            self._marks[key] = time.perf_counter()
            return
        ev = self._events.get(key)
        if ev is None:
            ev = self._events[key] = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        self._marks[key] = ev

    def read_marks(self) -> None:
        """Add every device span whose two marks were set since
        :meth:`start_marks`. On a card the caller has synchronised past
        the last mark (a copy of the results to the host)."""
        m = self._marks
        for name, (a, b) in self._spans.items():
            if a in m and b in m:
                self.device_s[name] += (
                    m[a].elapsed_time(m[b]) * 1e-3 if self._cuda
                    else m[b] - m[a])
        m.clear()
