"""One epoch of the XF flag barrier: CUDA kernel, plain version, and the
windowed planner the sync library calls.

Counterpart of ``repro.kernels.xf_barrier`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/xf_barrier.cu``; its header says
what bounds it on the H100. ``present`` slots write ``epoch`` into their
own flag word; the master checks the ``required`` slots within a poll
budget and releases them only if every one arrived:

* :func:`xf_barrier` — CUDA tensors launch the kernel (one CTA per
  participant, all co-resident); CPU tensors take the plain version.
  Returns ``(arrive', release, done, stragglers)``, all int32.
* :func:`xf_barrier_window` — numpy in/out, padded to power-of-2
  windows with absent, non-required slots (``_pad_barrier``), on the
  device the caller names (``cuda`` by default).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.sync.window import WindowedPlanner

from .build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
XF_BARRIER = CudaKernel(
    "xf_barrier.cu", "xf_barrier_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P])

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def xf_barrier(arrive: torch.Tensor, epoch: int, present: torch.Tensor,
               required: torch.Tensor, *, max_polls: int = 1024) -> Result:
    """One barrier epoch over ``(N,)`` flag words from earlier epochs.
    ``done`` is a 0-d int32 tensor; the rest are ``(N,)`` int32."""
    if arrive.dim() != 1 or present.shape != arrive.shape \
            or required.shape != arrive.shape:
        raise ValueError(f"expected (N,) arrive, present, required; got "
                         f"{tuple(arrive.shape)}, {tuple(present.shape)}, "
                         f"{tuple(required.shape)}")
    if len({arrive.device, present.device, required.device}) != 1:
        raise ValueError("xf_barrier inputs on different devices")
    if max_polls < 0:
        raise ValueError("max_polls must be >= 0")
    if arrive.device.type == "cpu":
        return xf_barrier_plain(arrive, epoch, present, required)
    if arrive.device.type != "cuda":
        raise ValueError(f"xf_barrier runs on cuda or cpu, not "
                         f"{arrive.device}")
    n = arrive.shape[0]
    dev = arrive.device
    # the TPU kernel's step-0 copy: flags of absent slots carry over
    out = arrive.to(torch.int32).contiguous().clone()
    pres = present.to(torch.int32).contiguous()
    req = required.to(torch.int32).contiguous()
    release = torch.zeros(n, dtype=torch.int32, device=dev)
    stragglers = torch.zeros(n, dtype=torch.int32, device=dev)
    # an empty barrier completes vacuously, as in the plain version
    done = torch.full((), int(n == 0), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        XF_BARRIER.launch(out.data_ptr(), pres.data_ptr(), req.data_ptr(),
                          release.data_ptr(), stragglers.data_ptr(),
                          done.data_ptr(), int(epoch), int(max_polls), n,
                          stream)
    return out, release, done, stragglers


def xf_barrier_plain(arrive: torch.Tensor, epoch: int,
                     present: torch.Tensor, required: torch.Tensor
                     ) -> Result:
    """Reference semantics of one epoch (the counterpart of
    ``ref.py::xf_barrier_ref``): present slots write ``epoch``; a
    required slot that is not present leaves the barrier incomplete —
    done = 0, no release, and the slot in the straggler bitmap."""
    arrive = arrive.to(torch.int32)
    pres = present.to(torch.int32) > 0
    req = required.to(torch.int32) > 0
    ep = torch.tensor(int(epoch), dtype=torch.int32, device=arrive.device)
    new_arrive = torch.where(pres, ep, arrive)
    arrived = bool(torch.all(torch.where(req, new_arrive >= ep, True)))
    stragglers = (req & (new_arrive < ep)).to(torch.int32)
    release = torch.where(req & arrived, ep, torch.zeros_like(arrive))
    done = torch.tensor(int(arrived), dtype=torch.int32,
                        device=arrive.device)
    return new_arrive, release, done, stragglers


def fresh_flags(n: int, device=None) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int32,
                       device=resolve_device(device))


def _pad_barrier(arrays, n: int, window: int):
    """Pad with absent, non-required slots: they never arrive and the
    master never checks them, so done/stragglers are unchanged."""
    arrive, present, required = arrays
    pad = window - n
    z = np.zeros(pad, np.int32)
    return (np.concatenate([arrive, z]),
            np.concatenate([present, z]),
            np.concatenate([required, z]))


def _plan(arrive, present, required, *, epoch, max_polls, device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    outs = xf_barrier(put(arrive), epoch, put(present), put(required),
                      max_polls=max_polls)
    return tuple(o.cpu().numpy() for o in outs)


_barrier_window = WindowedPlanner(
    plan=_plan, pad=_pad_barrier, base_window=32, name="xf_barrier_window")


def xf_barrier_window(arrive, epoch, present, required, *,
                      max_polls: int = 1024, window: int = 32, device=None):
    """Fixed-shape barrier epoch on power-of-2 bucketed windows (see
    ``WindowedPlanner``), on ``device`` (``cuda`` unless the caller asks
    for ``cpu``). Returns numpy ``(arrive', release, done, stragglers)``
    of the original length."""
    device = resolve_device(device)
    arrive = np.asarray(arrive, np.int32)
    present = np.asarray(present, np.int32)
    required = np.asarray(required, np.int32)
    return _barrier_window(arrive, present, required, window=window,
                           epoch=int(epoch), max_polls=max_polls,
                           device=device)
