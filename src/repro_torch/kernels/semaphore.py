"""Algorithm-5 semaphore admission timeline: CUDA kernel, plain version,
a CPU model of the kernel's algorithm, and the fixed-window planner the
serving engine calls every round.

Counterpart of ``repro.kernels.semaphore`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/semaphore_admission.cu``; its header
says what bounds it on the H100. For N FIFO arrivals sorted ascending
and K slots (the paper's sleeping semaphore is a K-server FIFO queue):

    grant_i = max(arrive_i, earliest slot-free time)
    release_i = grant_i + hold_i,   waited_i = (all K busy at arrive_i)

* :func:`semaphore_admission` — CUDA tensors launch the kernel; CPU
  tensors take the plain version. Both use only max, min and one float32
  add, so their outputs are bit-identical to each other and to the TPU
  kernel's.
* :func:`semaphore_admission_model` — the kernel's order-free update in
  numpy, with its slot layouts (registers up to ``REGISTER_CAPACITY``
  slots, a column per lane above), integer keys and the first tied lane,
  for the CPU tests.
* :class:`AdmissionWindow` — numpy in/out, padded to a fixed
  power-of-2 window with far-future zero-hold arrivals (``_pad_admission``)
  so every planning launch has one shape. On a CUDA device a plan is one
  packed copy to the card from a reused pinned buffer, one launch and
  one packed copy back, because the engine reads ``waited`` on the host.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.sync.window import WindowedPlanner

from .build import CudaKernel, PlanStaging

#: Up to this many slots the kernel keeps slot times in registers; above
#: it, in a column per lane of a ``capacity``-float scratch buffer on the
#: device. Any capacity >= 1 plans (the buffer is the only cost).
REGISTER_CAPACITY = 1024
_BIG = np.float32(3.4e38)

_P, _I = ctypes.c_void_p, ctypes.c_int
SEMAPHORE_ADMISSION = CudaKernel(
    "semaphore_admission.cu", "semaphore_admission_launch",
    [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    plan_argtypes=[_P] * 4 + [_I, _I, _P, _P])

Plan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def semaphore_admission(arrive_t: torch.Tensor, hold: torch.Tensor,
                        capacity: int) -> Plan:
    """``(grant, release, waited)`` for ``(N,)`` float32 arrivals sorted
    ascending and holds; ``waited`` is int32."""
    if arrive_t.dim() != 1 or hold.shape != arrive_t.shape:
        raise ValueError(f"expected (N,) arrivals and holds; got "
                         f"{tuple(arrive_t.shape)}, {tuple(hold.shape)}")
    if capacity < 1:
        raise ValueError(f"capacity {capacity} must be >= 1")
    if arrive_t.device != hold.device:
        raise ValueError("arrivals and holds on different devices")
    if arrive_t.device.type == "cpu":
        return semaphore_admission_plain(arrive_t, hold, capacity)
    if arrive_t.device.type != "cuda":
        raise ValueError(f"semaphore_admission runs on cuda or cpu, not "
                         f"{arrive_t.device}")
    if arrive_t.dtype != torch.float32 or hold.dtype != torch.float32:
        raise TypeError("arrivals and holds must be float32")
    if not (arrive_t.is_contiguous() and hold.is_contiguous()):
        raise ValueError("semaphore_admission needs contiguous inputs")
    n = arrive_t.shape[0]
    grant = torch.empty_like(arrive_t)
    release = torch.empty_like(arrive_t)
    waited = torch.empty(n, dtype=torch.int32, device=arrive_t.device)
    scratch = _scratch(capacity, arrive_t.device)
    with torch.cuda.device(arrive_t.device):
        stream = torch.cuda.current_stream(arrive_t.device).cuda_stream
        SEMAPHORE_ADMISSION.launch(
            arrive_t.data_ptr(), hold.data_ptr(), grant.data_ptr(),
            release.data_ptr(), waited.data_ptr(), n, capacity,
            0 if scratch is None else scratch.data_ptr(), stream)
    return grant, release, waited


def _scratch(capacity: int, device):
    """The column kernel's slot times (``capacity`` floats; the kernel
    fills them), or None when the slots fit in registers."""
    if capacity <= REGISTER_CAPACITY:
        return None
    return torch.empty(capacity, dtype=torch.float32, device=device)


def semaphore_admission_plain(arrive_t: torch.Tensor, hold: torch.Tensor,
                              capacity: int) -> Plan:
    """The sequential K-server FIFO loop in float32 numpy (the
    counterpart of ``ref.py::sleeping_semaphore_ref``)."""
    arr = arrive_t.detach().cpu().numpy().astype(np.float32)
    hld = hold.detach().cpu().numpy().astype(np.float32)
    n = arr.shape[0]
    slots = np.full(capacity, -_BIG, np.float32)
    grant = np.empty(n, np.float32)
    release = np.empty(n, np.float32)
    waited = np.empty(n, np.int32)
    for i in range(n):
        k = int(np.argmin(slots))          # lowest index on a tie
        free_t = slots[k]
        grant[i] = max(arr[i], free_t)
        release[i] = grant[i] + hld[i]     # float32 + float32
        waited[i] = int(free_t > arr[i])
        slots[k] = release[i]
    dev = arrive_t.device
    return (torch.from_numpy(grant).to(dev), torch.from_numpy(release).to(dev),
            torch.from_numpy(waited).to(dev))


def _key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 key of float32 values."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _replace_min(s: np.ndarray, r: np.float32) -> np.ndarray:
    """The kernel's insertion network: ``s`` sorted ascending, drop s[0],
    insert ``r``, stay sorted (only min and max of the same values)."""
    if s.shape[0] == 1:
        return np.array([r], np.float32)
    return np.concatenate([[np.minimum(s[1], r)],
                           np.minimum(s[2:], np.maximum(s[1:-1], r)),
                           [np.maximum(s[-1], r)]]).astype(np.float32)


def semaphore_admission_model(arrive_t, hold, capacity: int):
    """The CUDA kernel's algorithm in numpy: ``(grant, release, waited)``.

    Up to ``REGISTER_CAPACITY`` slots, lane l of 32 holds slots l, l+32,
    ... sorted (a power-of-2 row, +inf padded); above it, lane l owns the
    column ``[l w, (l + 1) w)`` of ``w = ceil(K / 32)`` unsorted slot
    times and the position of its minimum (:func:`_column_model`). The
    warp minimum is the least order-preserving key of the lanes' minima,
    decoded back to the exact value, and the first lane whose key ties
    takes release_i.
    Which slot is replaced differs from the reference's lowest index;
    the multiset of slot times, and so every output, does not."""
    arr = np.asarray(arrive_t, np.float32)
    hld = np.asarray(hold, np.float32)
    if capacity < 1:
        raise ValueError(f"capacity {capacity} must be >= 1")
    if capacity > REGISTER_CAPACITY:
        return _column_model(arr, hld, capacity)
    width = 1
    while 32 * width < capacity:
        width *= 2
    slot = np.arange(32)[:, None] + 32 * np.arange(width)[None]
    rows = np.where(slot < capacity, -_BIG, np.float32(np.inf)).astype(
        np.float32)                     # (lanes, slots per lane)
    n = arr.shape[0]
    grant = np.empty(n, np.float32)
    release = np.empty(n, np.float32)
    waited = np.empty(n, np.int32)
    for i in range(n):
        keys = _key(rows[:, 0])
        lane = int(np.argmin(keys))     # first lane holding the minimum
        free_t = rows[lane, 0]
        grant[i] = np.maximum(arr[i], free_t)
        release[i] = grant[i] + hld[i]  # float32 + float32
        waited[i] = int(free_t > arr[i])
        rows[lane] = _replace_min(rows[lane], release[i])
    return grant, release, waited


def _column_model(arr, hld, capacity: int):
    """The column kernel: lane l's slots are ``cols[l, :lens[l]]``; after
    taking release_i the lane rescans its own column for the first
    position of its least key."""
    width = -(-capacity // 32)
    lo = np.minimum(np.arange(32) * width, capacity)
    lens = np.minimum(lo + width, capacity) - lo
    cols = np.full((32, width), np.float32(np.inf), np.float32)
    for lane in range(32):
        cols[lane, :lens[lane]] = -_BIG
    at = np.zeros(32, np.int64)
    keys = _key(np.where(lens > 0, -_BIG, np.float32(np.inf)))
    n = arr.shape[0]
    grant = np.empty(n, np.float32)
    release = np.empty(n, np.float32)
    waited = np.empty(n, np.int32)
    for i in range(n):
        lane = int(np.argmin(keys))     # first lane holding the minimum
        free_t = cols[lane, at[lane]]
        grant[i] = np.maximum(arr[i], free_t)
        release[i] = grant[i] + hld[i]  # float32 + float32
        waited[i] = int(free_t > arr[i])
        cols[lane, at[lane]] = release[i]
        col_keys = _key(cols[lane, :lens[lane]])
        at[lane] = int(np.argmin(col_keys))
        keys[lane] = col_keys[at[lane]]
    return grant, release, waited


def _pad_admission(arrays, n: int, window: int):
    """Pad with far-future zero-hold arrivals: they keep the arrival sort
    ascending and can never steal a slot from a real request before it
    is granted."""
    arrive_t, hold = arrays
    horizon = (float(arrive_t.max()) if n else 0.0) + 1e6
    pad_arr = horizon + np.arange(window - n, dtype=np.float32)
    return (np.concatenate([arrive_t, pad_arr]),
            np.concatenate([hold, np.zeros(window - n, np.float32)]))


class AdmissionWindow:
    """The windowed planner bound to one device: numpy in, numpy out.

    On a CUDA device each window size keeps a pinned host buffer and a
    device buffer for the packed inputs (arrive | hold) and for the
    packed outputs (grant bits | release bits | waited), so a plan is
    one call into the kernel's library: one asynchronous copy in, one
    launch, one copy out and one stream synchronise. Several threads may
    plan through one window at once (``PlanStaging.run``). Above
    ``REGISTER_CAPACITY`` slots each window size and capacity also keeps
    the kernel's slot scratch, which the plan's launch fills itself."""

    def __init__(self, device, base_window: int = 32):
        self.device = torch.device(device)
        self.planner = WindowedPlanner(
            plan=self._plan, pad=_pad_admission, base_window=base_window,
            name="semaphore_admission_window")
        self._buffers = {}
        self._scratch = {}

    def _plan(self, arrive_t, hold, *, capacity):
        if self.device.type != "cuda":
            g, r, w = semaphore_admission(
                torch.from_numpy(np.ascontiguousarray(arrive_t, np.float32)),
                torch.from_numpy(np.ascontiguousarray(hold, np.float32)),
                capacity)
            return g.numpy(), r.numpy(), w.numpy()
        if capacity < 1:
            raise ValueError(f"capacity {capacity} must be >= 1")
        n = arrive_t.shape[0]
        stage = self._buffers.get(n)
        if stage is None:
            stage = self._buffers.setdefault(
                n, PlanStaging(self.device, 2 * n, 3 * n))
        # one scratch per staging buffer: its lock serialises the plans
        # that use it
        scratch = self._scratch.get((n, capacity))
        if scratch is None and capacity > REGISTER_CAPACITY:
            scratch = self._scratch.setdefault(
                (n, capacity),
                _scratch(capacity, torch.device("cuda", stage.index)))
        out = stage.run(SEMAPHORE_ADMISSION,
                        (np.asarray(arrive_t, np.float32),
                         np.asarray(hold, np.float32)), n, capacity,
                        0 if scratch is None else scratch.data_ptr())
        return (out[:n].view(np.float32), out[n:2 * n].view(np.float32),
                out[2 * n:])

    def __call__(self, arrive_t, hold, *, capacity: int, window: int = None):
        return self.planner(np.asarray(arrive_t, np.float32),
                            np.asarray(hold, np.float32),
                            window=window, capacity=capacity)

