"""Algorithm-5 semaphore admission timeline: CUDA kernel, plain version,
and the fixed-window planner the serving engine calls every round.

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
* :class:`AdmissionWindow` — numpy in/out, padded to a fixed
  power-of-2 window with far-future zero-hold arrivals (``_pad_admission``)
  so every planning launch has one shape; on a CUDA device the plan ends
  in a device-to-host copy, because the engine reads ``waited`` on the
  host.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.sync.window import WindowedPlanner

from .build import CudaKernel

MAX_CAPACITY = 1024
_BIG = np.float32(3.4e38)

_P, _I = ctypes.c_void_p, ctypes.c_int
SEMAPHORE_ADMISSION = CudaKernel(
    "semaphore_admission.cu", "semaphore_admission_launch",
    [_P, _P, _P, _P, _P, _I, _I, _P])

Plan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def semaphore_admission(arrive_t: torch.Tensor, hold: torch.Tensor,
                        capacity: int) -> Plan:
    """``(grant, release, waited)`` for ``(N,)`` float32 arrivals sorted
    ascending and holds; ``waited`` is int32."""
    if arrive_t.dim() != 1 or hold.shape != arrive_t.shape:
        raise ValueError(f"expected (N,) arrivals and holds; got "
                         f"{tuple(arrive_t.shape)}, {tuple(hold.shape)}")
    if not 1 <= capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity {capacity} outside [1, {MAX_CAPACITY}]")
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
    with torch.cuda.device(arrive_t.device):
        stream = torch.cuda.current_stream(arrive_t.device).cuda_stream
        SEMAPHORE_ADMISSION.launch(
            arrive_t.data_ptr(), hold.data_ptr(), grant.data_ptr(),
            release.data_ptr(), waited.data_ptr(), n, capacity, stream)
    return grant, release, waited


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
    """The windowed planner bound to one device: numpy in, numpy out."""

    def __init__(self, device, base_window: int = 32):
        self.device = torch.device(device)
        self.planner = WindowedPlanner(
            plan=self._plan, pad=_pad_admission, base_window=base_window,
            name="semaphore_admission_window")

    def _plan(self, arrive_t, hold, *, capacity):
        a = torch.from_numpy(np.ascontiguousarray(arrive_t, np.float32))
        h = torch.from_numpy(np.ascontiguousarray(hold, np.float32))
        g, r, w = semaphore_admission(a.to(self.device), h.to(self.device),
                                      capacity)
        return g.cpu().numpy(), r.cpu().numpy(), w.cpu().numpy()

    def __call__(self, arrive_t, hold, *, capacity: int, window: int = None):
        return self.planner(np.asarray(arrive_t, np.float32),
                            np.asarray(hold, np.float32),
                            window=window, capacity=capacity)

