"""One epoch of the XF flag barrier: CUDA kernel, plain version, the
kernel's schedule model, and the windowed planner the sync library
calls.

Counterpart of ``repro.kernels.xf_barrier`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/xf_barrier.cu``; its header says
what bounds it on the H100. ``present`` slots write ``epoch`` into their
own flag word; the master checks the ``required`` slots within a poll
budget and releases them only if every one arrived:

* :func:`xf_barrier` — CUDA tensors launch the kernel (the participants
  are threads of one CTA, their flags in its shared memory up to
  ``SHARED_N`` participants, in global memory above); CPU tensors
  take the plain version. Returns ``(arrive', release, done,
  stragglers)``, all int32.
* :func:`xf_barrier_schedule_model` — the kernel's schedule (thread
  slots that own every T-th participant, a master that first waits for
  every present flag, then polls the required ones within the budget)
  stepped in pure Python, for the CPU tests.
* :func:`xf_barrier_window` — numpy in/out, padded to power-of-2
  windows with absent, non-required slots (``_pad_barrier``), on the
  device the caller names (``cuda`` by default). On a CUDA device a plan
  is one packed copy to the card from a reused pinned buffer, one
  launch, one packed copy back and one stream synchronise; the error
  word is read from the host copy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.sync.window import WindowedPlanner

from .build import CudaKernel, KernelError, PlanStaging

_P, _I = ctypes.c_void_p, ctypes.c_int
XF_BARRIER = CudaKernel(
    "xf_barrier.cu", "xf_barrier_launch", [_P, _P, _I, _I, _I, _P],
    plan_argtypes=[_P] * 4 + [_I, _I, _I, _P])

#: Up to this many participants the kernel keeps flags and membership
#: bytes in its CTA's shared memory; above it, the flags are the output's
#: arrive' words in global memory. Any N plans.
SHARED_N = 32768
CHUNK = 128            # flag words one check of the kernel's master reads
MAX_WAIT_POLLS = 1000000
_EXPIRED = (f"the master exhausted its {MAX_WAIT_POLLS:,}-poll guard "
            f"waiting for a present participant")

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def xf_barrier(arrive: torch.Tensor, epoch: int, present: torch.Tensor,
               required: torch.Tensor, *, max_polls: int = 1024,
               check: bool = True) -> Result:
    """One barrier epoch over ``(N,)`` flag words from earlier epochs.
    ``done`` is a 0-d int32 tensor; the rest are ``(N,)`` int32.

    On a CUDA tensor the four results are views of one int32 output that
    the kernel fills whole; an exhausted wait guard raises, and
    ``check=False`` defers that read to ``XF_BARRIER.check_pending()``
    (timing loops)."""
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
    packed = torch.cat([x.to(torch.int32) for x in (arrive, present,
                                                      required)])
    out = torch.empty(3 * n + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        XF_BARRIER.launch(packed.data_ptr(), out.data_ptr(), int(epoch),
                          int(max_polls), n,
                          torch.cuda.current_stream(dev).cuda_stream)
    XF_BARRIER.check_word(out[3 * n + 1:], _EXPIRED, check)
    return out[:n], out[n:2 * n], out[3 * n], out[2 * n:3 * n]


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


def xf_barrier_schedule_model(arrive, epoch, present, required, *,
                              slots: int, max_polls: int = 1024,
                              seed: int = 0):
    """The CUDA kernel's schedule stepped in pure Python: numpy
    ``(arrive', release, done, stragglers)``.

    ``slots`` thread slots each own participants s, s + slots, ... and
    store ``epoch`` into the flag of each present one, one store a step.
    The slot that owns participant n - 1 becomes the master once its own
    stores are done. Its cursor walks the flags in chunks of ``CHUNK``
    words; one master step is one poll, which passes every chunk whose
    words all meet the condition and stops at the first that does not.
    First it polls, with no budget, until every present flag reads
    ``epoch``; then it checks the required flags (``>= epoch``) once and
    re-checks up to ``max_polls`` times. Each step advances one slot,
    picked by a seeded generator from those with work left, so many
    interleavings of stores and polls are tried. Asserts that the master
    never waits on a present flag that no slot will write (the schedule
    cannot hang for any ``slots`` >= 1)."""
    flags = [int(x) for x in np.asarray(arrive, np.int32)]
    pres = [bool(x > 0) for x in np.asarray(present, np.int32)]
    req = [bool(x > 0) for x in np.asarray(required, np.int32)]
    n = len(flags)
    if slots < 1:
        raise ValueError("slots must be >= 1")
    rng = np.random.default_rng(seed)
    master = (n - 1) % slots if n else 0
    # each slot's present participants still to store, in order
    todo = {s: [k for k in range(s, n, slots) if pres[k]]
            for s in range(min(slots, max(n, 1)))}
    base, phase, polls, arrived = 0, "present", 0, False

    def poll(met):
        nonlocal base
        while base < n and all(met(k) for k in range(base,
                                                     min(base + CHUNK, n))):
            base += CHUNK
        return base >= n

    while True:
        ready = [s for s, ks in todo.items() if ks]
        if not todo[master] and phase != "done":
            ready.append(-1)                      # the master can poll
        if not ready:
            break
        s = ready[int(rng.integers(len(ready)))]
        if s >= 0:
            flags[todo[s].pop(0)] = int(epoch)
            continue
        if phase == "present":
            if poll(lambda k: not pres[k] or flags[k] == epoch):
                phase, polls, base = "required", -1, 0
                continue
            waiting = [k for k in range(n) if pres[k] and flags[k] != epoch]
            assert all(k in todo[k % slots] for k in waiting), (
                f"the master waits on present flags {waiting} that no slot "
                f"will write")
            continue
        # the budgeted loop: the first check (polls -1), then re-checks
        arrived = poll(lambda k: not req[k] or flags[k] >= epoch)
        polls += 1
        if arrived or polls >= max_polls:
            phase = "done"
    a = np.asarray(flags, np.int32)
    rq = np.asarray(req, bool)
    release = np.where(rq & arrived, np.int32(epoch), 0).astype(np.int32)
    stragglers = (rq & (a < epoch)).astype(np.int32)
    return a, release, np.int32(arrived), stragglers


def _pad_barrier(arrays, n: int, window: int):
    """Pad with absent, non-required slots: they never arrive and the
    master never checks them, so done/stragglers are unchanged."""
    arrive, present, required = arrays
    pad = window - n
    z = np.zeros(pad, np.int32)
    return (np.concatenate([arrive, z]),
            np.concatenate([present, z]),
            np.concatenate([required, z]))


_staging = {}


def _plan(arrive, present, required, *, epoch, max_polls, device):
    """One padded window on ``device``. On a CUDA device one call into
    the kernel's library copies ``arrive | present | required`` over
    from the window's pinned buffer, launches, copies ``arrive' | release
    | stragglers | done | error`` back into pinned memory and
    synchronises the stream (``PlanStaging.run``, safe to call from
    several threads)."""
    parts = tuple(np.ascontiguousarray(a, np.int32)
                  for a in (arrive, present, required))
    if max_polls < 0:
        raise ValueError("max_polls must be >= 0")
    if device.type != "cuda":
        a, p, r = (torch.from_numpy(x) for x in parts)
        return tuple(o.numpy() for o in xf_barrier(a, epoch, p, r,
                                                   max_polls=max_polls))
    n = parts[0].shape[0]
    stage = _staging.get((device, n))
    if stage is None:
        stage = _staging.setdefault((device, n),
                                    PlanStaging(device, 3 * n, 3 * n + 2))
    out = stage.run(XF_BARRIER, parts, int(epoch), int(max_polls), n)
    if out[3 * n + 1] != 0:
        raise KernelError(f"{XF_BARRIER.symbol}: {_EXPIRED}")
    return out[:n], out[n:2 * n], out[3 * n], out[2 * n:3 * n]


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
