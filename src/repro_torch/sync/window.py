"""Fixed-window padding with power-of-2 buckets for timeline planners.

A copy of ``repro.sync.window`` (the port imports nothing of the JAX
package). Schedulers plan every round over a trace whose length varies
— in-flight holds plus whatever is queued. ``WindowedPlanner`` pads the
trace to a window and slices the padding back off; a trace longer than
the base window is bucketed to the next power-of-2 multiple, with a
one-time warning that the caller's window estimate was low. On the GPU
a fixed window keeps each planning launch the same shape; the padding
itself is family-specific (far-future arrivals for the semaphore), so
each family supplies a ``pad`` callback.
"""

from __future__ import annotations

import warnings
from typing import Callable, Sequence, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, ...]


class WindowedPlanner:
    """Pad variable-length traces to power-of-2 bucketed windows.

    ``plan(*padded_arrays, **static) -> tuple`` is the planner;
    ``pad(arrays, n, window) -> tuple`` pads the ``n``-length inputs up
    to ``window`` without changing the plan of the first ``n`` entries.
    """

    def __init__(self, plan: Callable[..., Sequence],
                 pad: Callable[[Arrays, int, int], Arrays], *,
                 base_window: int = 32, name: str = "planner"):
        if base_window < 1:
            raise ValueError("base_window must be >= 1")
        self.plan = plan
        self.pad = pad
        self.base_window = base_window
        self.name = name
        self._warned = False

    def window_for(self, n: int, base: int = None) -> int:
        """Bucketed window for an ``n``-length trace: the smallest
        power-of-2 multiple of the base window that holds it."""
        w = max(int(base) if base is not None else self.base_window, 1)
        if n <= w:
            return w
        bucket = w
        while bucket < n:
            bucket *= 2
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"{self.name}: trace length {n} exceeds the planning "
                f"window {w}; bucketing to {bucket} (one shape per "
                f"power-of-2 bucket). Size the window from your capacity "
                f"+ queue bound to avoid this.",
                RuntimeWarning, stacklevel=3)
        return bucket

    def __call__(self, *arrays: np.ndarray, window: int = None, **static):
        n = int(arrays[0].shape[0])
        w = self.window_for(n, window)
        padded = self.pad(tuple(arrays), n, w)
        outs = self.plan(*padded, **static)
        return tuple(self._unpad(o, n, w) for o in outs)

    @staticmethod
    def _unpad(out, n: int, window: int):
        a = np.asarray(out)
        if a.ndim >= 1 and a.shape[0] == window:
            return a[:n]
        return a
