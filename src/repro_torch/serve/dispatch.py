"""Power-of-2 occupancy buckets for scheduler-round dispatch
(counterpart of ``repro.serve.dispatch``).

Each round gathers the active slots into the smallest power-of-2 bucket
that holds them (capped at capacity), runs the round at that row count,
and scatters per-row results back to the ``[K]`` state — so vacant
slots cost nothing and the set of dispatch shapes stays bounded by
``log2(capacity) + 1`` buckets (times the ``chunk ∈ {0, C}`` variants).
The reference jit-compiles one trace per shape; PyTorch runs eagerly,
so here the ledger only records which shapes were dispatched (the
bounded set a later CUDA-graph cache would capture, one graph each).
The bucket policy is the library's windowed planner's.
"""

from __future__ import annotations

from typing import Sequence, Set, Tuple

import numpy as np

from repro_torch.sync.window import WindowedPlanner

ShapeKey = Tuple[int, ...]


class DecodeDispatchCache:
    """Power-of-2 occupancy buckets + the ledger of dispatched shapes."""

    def __init__(self, capacity: int, *, base: int = 1):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.planner = WindowedPlanner(
            plan=None, pad=None, base_window=max(int(base), 1),
            name="decode-dispatch")
        # bucketing past the base window is this cache's design, not a
        # planner-window overflow — silence the one-time estimate warning
        self.planner._warned = True
        self.shapes: Set[ShapeKey] = set()

    def bucket(self, n: int) -> int:
        """Rows to dispatch for ``n`` active slots: the pow-2 bucket,
        capped at capacity."""
        return min(self.capacity, self.planner.window_for(max(int(n), 1)))

    def pad_rows(self, rows: Sequence[int], kb: int) -> np.ndarray:
        """[kb] int32 slot ids, padded with ``capacity`` — an
        out-of-range row the engine turns into an inert lane (frozen,
        sentinel table, length 0) whose results are never scattered
        back."""
        out = np.full(kb, self.capacity, np.int32)
        out[: len(rows)] = np.asarray(list(rows), np.int32)
        return out

    def record_shape(self, key: ShapeKey) -> None:
        self.shapes.add(tuple(key))
