"""The paper's Section-3 memory benchmark cells: CUDA kernel, plain
version, buffer maker and the cell timer.

Counterpart of ``repro.kernels.membench`` (kernel.py, ref.py and ops.py
there). The kernel is ``csrc/membench.cu``; its header says what it
measures on the H100. The cells are {contentious, noncontentious} x
{read, write} over ``(R, 128)`` float32 rows (512 bytes, as on the TPU):
step i hammers row 0 (contentious) or its own row i ``repeats`` times.

* :func:`membench` — CUDA tensors launch the kernel (one CTA of 128
  threads per step; the contentious write cell, whose result is the
  sequential order of its steps, one CTA that runs them in order); CPU
  tensors take the plain version. Returns
  ``(buffer', sums)``: the buffer after every step and each step's
  checksum. The buffers agree exactly; read checksums to float32
  rounding of ``repeats * row_sum``.
* :func:`time_cell` — the cell's time on the card from CUDA events, in
  ms per 1000 accesses per step (the paper's unit). It has no CPU mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.device import resolve_device

from .build import CudaKernel

LANE = 128  # float lanes per row: 512-byte rows, one CTA thread each

_P, _I = ctypes.c_void_p, ctypes.c_int
MEMBENCH = CudaKernel(
    "membench.cu", "membench_launch", [_P, _P, _I, _I, _I, _I, _P])

Result = Tuple[torch.Tensor, torch.Tensor]


def membench(buf: torch.Tensor, *, n_steps: int, contentious: bool,
             write: bool, repeats: int = 16) -> Result:
    """Run one cell of the benchmark grid on a ``(R, 128)`` float32
    buffer (``R >= n_steps`` for a noncontentious cell); the input is not
    modified."""
    if buf.dim() != 2 or buf.shape[1] != LANE:
        raise ValueError(f"expected a (R, {LANE}) buffer; got "
                         f"{tuple(buf.shape)}")
    if n_steps < 0 or repeats < 0:
        raise ValueError("n_steps and repeats must be >= 0")
    if not contentious and buf.shape[0] < n_steps:
        raise ValueError(f"a noncontentious cell needs one row per step: "
                         f"{buf.shape[0]} rows < {n_steps} steps")
    if buf.shape[0] < 1:
        raise ValueError("the buffer needs at least one row")
    if buf.device.type == "cpu":
        return membench_plain(buf, n_steps=n_steps, contentious=contentious,
                              write=write, repeats=repeats)
    if buf.device.type != "cuda":
        raise ValueError(f"membench runs on cuda or cpu, not {buf.device}")
    if buf.dtype != torch.float32:
        raise TypeError("membench needs a float32 buffer")
    dev = buf.device
    out = buf.contiguous().clone()
    sums = torch.empty(n_steps, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        MEMBENCH.launch(out.data_ptr(), sums.data_ptr(), n_steps,
                        int(contentious), int(write), repeats,
                        torch.cuda.current_stream(dev).cuda_stream)
    return out, sums


def membench_plain(buf: torch.Tensor, *, n_steps: int, contentious: bool,
                   write: bool, repeats: int = 16) -> Result:
    """Sequential-grid semantics (the counterpart of
    ``ref.py::membench_ref``): steps run in order 0..n_steps-1.

    write: step i stores (it + i + 1) for it in [0, repeats) to its row,
      which ends at repeats + i; the checksum is that value times 128.
    read: step i sums its row ``repeats`` times; rows never change, so
      the checksum is repeats * row_sum of the initial buffer.
    """
    out = buf.to(torch.float32).clone()
    steps = torch.arange(n_steps, device=buf.device)
    final = (repeats + steps).to(torch.float32)
    if write:
        if contentious:
            if n_steps:
                out[0] = final[-1]
        else:
            out[:n_steps] = final[:, None]
        return out, final * LANE
    rows = torch.zeros_like(steps) if contentious else steps
    return out, repeats * out[rows].sum(-1)


def make_buffer(n_steps: int, generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """``(max(8, n_steps), 128)`` float32: ``arange / 128`` without a
    generator, else uniform [0, 1) drawn from it."""
    dev = resolve_device(device)
    rows = max(8, n_steps)
    if generator is None:
        return (torch.arange(rows * LANE, dtype=torch.float32, device=dev)
                .reshape(rows, LANE) / LANE)
    return torch.rand((rows, LANE), generator=generator,
                      device=generator.device).to(dev)


def time_cell(n_steps: int = 64, *, contentious: bool, write: bool,
              repeats: int = 64, reps: int = 5, device=None) -> float:
    """Median device time of one benchmark cell over ``reps`` launches,
    from CUDA events, in ms per 1000 accesses per step. Raises on the
    CPU: a CPU time is not a time of the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_cell times the card; it has no CPU mode")
    buf = make_buffer(n_steps, device=dev)
    kw = dict(n_steps=n_steps, contentious=contentious, write=write,
              repeats=repeats)
    membench(buf, **kw)                       # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        membench(buf, **kw)
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2] * (1000.0 / max(repeats, 1))
