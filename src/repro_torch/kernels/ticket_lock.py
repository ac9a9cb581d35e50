"""Algorithm-3 fetch-and-add (ticket) mutex: CUDA kernel, plain version,
and the windowed planners the sync library calls.

Counterpart of ``repro.kernels.ticket_lock`` (kernel.py, ref.py and
ops.py there). The kernel is ``csrc/ticket_lock.cu``; its header says
what bounds it on the H100. N requesters take tickets in ``arrival``
order, each waits for its turn, runs the order-sensitive critical
section ``acc = acc * m + b`` and unlocks:

* :func:`ticket_lock` — CUDA tensors launch the kernel (the requesters
  are threads of one CTA, contending through its shared memory); CPU
  tensors take the plain version. Returns ``(grant_order, turn_trace,
  acc)``; the chain is folded with separate float32 multiply and add in
  both, so they are bit-equal.
* :func:`ticket_lock_schedule_model` — the kernel's schedule (slots that
  own every P-th requester) stepped in pure Python, for the CPU tests.
* :func:`ticket_lock_window` / :func:`ticket_lock_batch_window` — numpy
  in/out, padded to power-of-2 windows with identity requesters
  (``_pad_ticket``), on the device the caller names (``cuda`` by
  default). On a CUDA device a plan is one packed copy to the card from
  a reused pinned buffer, one launch, one packed copy back and one
  stream synchronise; the error word is read from the host copy.
* :func:`ticket_lock_bounded_oracle` — the numpy step-exact oracle of
  the bounded-wait mutex, a copy of the reference's.
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
TICKET_LOCK = CudaKernel(
    "ticket_lock.cu", "ticket_lock_launch",
    [_P, _P, _P, _P, _I, _P], plan_argtypes=[_P] * 4 + [_I, _P])

#: Up to this many requesters the kernel stages grant and trace in shared
#: memory; above it, it writes them straight to the output. Any N plans.
STAGED_N = 16384
_EXPIRED = "a requester exhausted its 1,000,000-poll budget"

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ticket_lock(arrival: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                *, check: bool = True) -> Result:
    """``(grant_order, turn_trace, acc)`` for ``(N,)`` int32 requester
    ids in processing order and ``(N,)`` float32 ``m``, ``b`` (positional:
    entry t belongs to the t-th ticket). ``acc`` is a 0-d float32 tensor.

    On a CUDA tensor the three results are views of one int32 output
    that the kernel fills whole; an exhausted poll budget raises, and
    ``check=False`` defers that read to ``TICKET_LOCK.check_pending()``
    (timing loops)."""
    if arrival.dim() != 1 or m.shape != arrival.shape \
            or b.shape != arrival.shape:
        raise ValueError(f"expected (N,) arrival, m, b; got "
                         f"{tuple(arrival.shape)}, {tuple(m.shape)}, "
                         f"{tuple(b.shape)}")
    if len({arrival.device, m.device, b.device}) != 1:
        raise ValueError("ticket_lock inputs on different devices")
    if arrival.device.type == "cpu":
        return ticket_lock_plain(arrival, m, b)
    if arrival.device.type != "cuda":
        raise ValueError(f"ticket_lock runs on cuda or cpu, not "
                         f"{arrival.device}")
    if arrival.dtype != torch.int32 or m.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError("arrival must be int32, m and b float32")
    if not (arrival.is_contiguous() and m.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("ticket_lock needs contiguous inputs")
    n = arrival.shape[0]
    dev = arrival.device
    out = torch.empty(2 * n + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        TICKET_LOCK.launch(
            arrival.data_ptr(), m.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, torch.cuda.current_stream(dev).cuda_stream)
    TICKET_LOCK.check_word(out[2 * n + 1:], _EXPIRED, check)
    return (out[:n], out[n:2 * n],
            out[2 * n:2 * n + 1].view(torch.float32).reshape(()))


def ticket_lock_plain(arrival: torch.Tensor, m: torch.Tensor,
                      b: torch.Tensor) -> Result:
    """FIFO ticket-mutex semantics (the counterpart of
    ``ref.py::ticket_lock_ref``): grant order == arrival, the observed
    turn equals the ticket, and the chain folds in ticket order with a
    float32 multiply and a float32 add."""
    arr = arrival.detach().cpu().numpy().astype(np.int32)
    mm = m.detach().cpu().numpy().astype(np.float32)
    bb = b.detach().cpu().numpy().astype(np.float32)
    acc = np.float32(0.0)
    for t in range(arr.shape[0]):
        acc = np.float32(acc * mm[t]) + bb[t]
    dev = arrival.device
    return (torch.from_numpy(arr.copy()).to(dev),
            torch.arange(arr.shape[0], dtype=torch.int32, device=dev),
            torch.tensor(acc, dtype=torch.float32, device=dev))


def ticket_lock_schedule_model(arrival, m, b, slots: int, *, seed: int = 0):
    """The CUDA kernel's schedule stepped in pure Python:
    ``(grant_order, turn_trace, acc)`` as lists and a float32.

    ``slots`` requester slots (threads of the kernel's CTA) each own
    requesters s, s + slots, s + 2 slots, ... and serve them in order:
    wait for the gate to reach j, take a ticket, bump the gate, wait for
    the turn to reach the ticket, run the critical section, bump the
    turn. Each step advances one slot whose wait is over, picked by a
    seeded generator, so many interleavings are tried. Asserts that no
    slot waits on a word that only it could move (the schedule cannot
    deadlock for any ``slots`` >= 1) and that tickets follow the arrival
    order."""
    arr = [int(x) for x in np.asarray(arrival, np.int32)]
    mm = np.asarray(m, np.float32)
    bb = np.asarray(b, np.float32)
    n = len(arr)
    if slots < 1:
        raise ValueError("slots must be >= 1")
    rng = np.random.default_rng(seed)
    gate = ticket = turn = 0
    acc = np.float32(0.0)
    grant, trace = [-1] * n, [-1] * n
    ticket_of, holder = [-1] * n, {}
    cur = list(range(min(slots, n)))      # each slot's current requester
    at_gate = [True] * len(cur)
    active = list(range(len(cur)))
    while active:
        ready = []
        for s in active:
            j = cur[s]
            want = j if at_gate[s] else ticket_of[j]
            if (gate if at_gate[s] else turn) == want:
                ready.append(s)
                continue
            # the word moves to ``want`` when requester ``mover`` passes it
            # on; that must be another slot's requester
            mover = j - 1 if at_gate[s] else holder[want - 1]
            assert mover % slots != s, (
                f"slot {s} waits on requester {mover}, which it owns")
        assert ready, "no slot can move: the schedule deadlocked"
        s = ready[int(rng.integers(len(ready)))]
        j = cur[s]
        if at_gate[s]:
            my, ticket, gate = ticket, ticket + 1, j + 1
            assert my == j, f"requester {j} took ticket {my}"
            ticket_of[j], holder[my] = my, j
            at_gate[s] = False
            continue
        my = ticket_of[j]
        grant[my], trace[my] = arr[j], turn
        acc = np.float32(np.float32(acc * mm[my]) + bb[my])
        turn = my + 1
        if j + slots < n:
            cur[s], at_gate[s] = j + slots, True
        else:
            active.remove(s)
    return grant, trace, acc


def _pad_ticket(arrays, n: int, window: int):
    """Pad with identity requesters arriving last: ids n..window-1 take
    the trailing tickets (real grants stay in the first n positions) and
    m=1, b=0 leaves the affine chain untouched."""
    arrival, m, b = arrays
    pad = window - n
    return (np.concatenate([arrival, np.arange(n, window, dtype=np.int32)]),
            np.concatenate([m, np.ones(pad, np.float32)]),
            np.concatenate([b, np.zeros(pad, np.float32)]))


_staging = {}


def _plan(arrival, m, b, *, device):
    """One padded window on ``device``. On a CUDA device one call into
    the kernel's library copies ``arrival | m bits | b bits`` over from
    the window's pinned buffer, launches, copies ``grant | trace | acc
    bits | error`` back into pinned memory and synchronises the stream
    (``PlanStaging.run``, safe to call from several threads)."""
    if device.type != "cuda":
        g, t, acc = ticket_lock(
            *(torch.from_numpy(np.ascontiguousarray(a, dt))
              for a, dt in ((arrival, np.int32), (m, np.float32),
                            (b, np.float32))))
        return g.numpy(), t.numpy(), acc.numpy()
    n = arrival.shape[0]
    stage = _staging.get((device, n))
    if stage is None:
        stage = _staging.setdefault((device, n),
                                    PlanStaging(device, 3 * n, 2 * n + 2))
    out = stage.run(TICKET_LOCK, (np.asarray(arrival, np.int32),
                                  np.asarray(m, np.float32),
                                  np.asarray(b, np.float32)), n)
    if out[2 * n + 1] != 0:
        raise KernelError(f"{TICKET_LOCK.symbol}: {_EXPIRED}")
    return out[:n], out[n:2 * n], out[2 * n:2 * n + 1].view(np.float32)[0]


_ticket_window = WindowedPlanner(
    plan=_plan, pad=_pad_ticket, base_window=32, name="ticket_lock_window")


def ticket_lock_window(arrival, m=None, b=None, *, window: int = 32,
                       device=None):
    """Fixed-shape ticket-lock planning on power-of-2 bucketed windows
    (see ``WindowedPlanner``), on ``device`` (``cuda`` unless the caller
    asks for ``cpu``). Returns numpy ``(grant_order, turn_trace, acc)``
    of the original length."""
    device = resolve_device(device)
    arrival = np.asarray(arrival, np.int32)
    n = arrival.shape[0]
    m = (np.ones(n, np.float32) if m is None
         else np.asarray(m, np.float32))
    b = (np.zeros(n, np.float32) if b is None
         else np.asarray(b, np.float32))
    return _ticket_window(arrival, m, b, window=window, device=device)


def ticket_lock_bounded_oracle(arrivals, holds, timeouts):
    """Step-exact oracle for the *bounded-wait* FIFO ticket mutex: the
    ground truth ``SyncLibrary.plan_mutex_bounded`` must reach on every
    backend.

    Tickets issue in stable arrival order. Walking tickets in order with
    a running lock-free time: requester ``i``'s turn arrives at
    ``max(arrival_i, t_free)``; if the wait exceeds ``timeout_i`` the
    ticket *burns* — never granted, zero hold, the turn passes
    immediately (the live ``TicketMutex`` timeout discipline) — else it
    holds for ``hold_i``. One forward pass is exact because a ticket's
    fate depends only on earlier tickets' fates.

    Returns ``(granted, grant, release)``: bool mask + turn/release
    times, caller order.
    """
    arrivals = np.asarray(arrivals, np.float64)
    holds = np.asarray(holds, np.float64)
    timeouts = np.asarray(timeouts, np.float64)
    n = arrivals.shape[0]
    granted = np.zeros(n, bool)
    grant = np.zeros(n, np.float64)
    release = np.zeros(n, np.float64)
    t_free = -np.inf
    for i in np.argsort(arrivals, kind="stable"):
        g = max(float(arrivals[i]), t_free)
        grant[i] = g
        if g - arrivals[i] > timeouts[i]:
            release[i] = g                    # burned: pass the turn on
            t_free = g
        else:
            granted[i] = True
            release[i] = g + holds[i]
            t_free = release[i]
    return granted, grant, release


def ticket_lock_batch_window(arrival, counts, *, window: int = 32,
                             device=None):
    """Plan one *batched-grant* allocator round under the FIFO ticket
    lock: requester ``i``'s single critical section grants ``counts[i]``
    pages (the ``PagePool.alloc_batch`` discipline), so the round costs
    one fetch-and-add per requester instead of one per page.

    Runs the same Algorithm-3 kernel as :func:`ticket_lock_window` with
    the page counts riding the critical-section chain (``m=1``,
    ``b=counts`` — the affine accumulator becomes the running page
    total), on the same windows. Returns numpy

      * ``grant_order`` — requester ids in lock-grant (FIFO ticket)
        order: identical to the order a per-page loop would grant;
      * ``pages_start`` — exclusive running page total when each
        requester (``counts`` is positional, like ``m``/``b``: entry
        ``j`` belongs to the ``j``-th ticket) enters its critical
        section: the offset of its first page in the round's page stream;
      * ``total_pages`` — pages granted by the whole round;
      * ``atomics`` — ``(batched, per_page)`` synchronizing-access
        counts for the round: ``n`` one-FA acquires vs the
        ``total_pages`` a page-at-a-time loop would have issued.
    """
    device = resolve_device(device)
    arrival = np.asarray(arrival, np.int32)
    counts = np.asarray(counts, np.int64)
    if counts.shape != arrival.shape:
        raise ValueError("counts must have one entry per requester")
    if np.any(counts < 0):
        raise ValueError("negative page count")
    n = arrival.shape[0]
    grant_order, _, total = _ticket_window(
        arrival, np.ones(n, np.float32), counts.astype(np.float32),
        window=window, device=device)
    grant_order = np.asarray(grant_order, np.int64)
    pages_start = np.concatenate(
        [[0], np.cumsum(counts)[:-1]]) if n else np.zeros(0, np.int64)
    total_pages = int(round(float(total)))
    return grant_order, pages_start, total_pages, (n, total_pages)
