"""Per-device statistics of a traced step (counterpart of
``repro.analysis.hlo_stats``).

The reference reads flops, HBM bytes and collectives from the compiled
post-SPMD HLO text. Torch emits no HLO, so the port counts the step as
it runs: :class:`StepCounter` is a ``TorchDispatchMode`` that sees every
aten op on **local** (per-device) tensors. For an op on ``DTensor``s it
returns ``NotImplemented``, so DTensor first turns the op into its
local ops and the collectives of its redistributions, and the mode
counts those. A replicated op therefore counts in full on every device,
and a sharded one at its shard's size. The step is run on ``meta``
tensors (shapes only) over a fake process group, so nothing is
allocated and nothing is sent (``launch/dryrun.py``).

What is counted, with the reference's rules:

  1. ``flops``: the contractions (``mm`` / ``bmm`` / ``addmm`` /
     ``baddbmm``, convolutions, fused attention), 2 * M * N * K each,
     by ``torch.utils.flop_counter``'s formulas;
  2. ``elementwise_flops``: one flop per output element of the aten
     counterparts of the reference's arithmetic set (``_ELEMENTWISE``);
  3. ``collectives``: per kind, count, result bytes and wire bytes with
     the group size g: all-reduce 2(g-1)/g, all-gather and all-to-all
     (g-1)/g of the result, reduce-scatter (g-1)/g of the result x g;
  4. ``hbm_bytes``: the local inputs and outputs of every op that is not
     a view, an upper bound (no fusion);
  5. ``hbm_bytes_opt``: the reference's optimistic rule — contraction
     operands and results, collective results, scatters into a buffer at
     twice the written bytes, and reads of state (the tensors passed as
     ``state``: parameters, optimizer state, the cache) by any other op,
     each clipped to that op's result bytes.

A loop that the reference scans (layers, microbatches) runs here as
Python, once per trip, so trip counts need no special handling; a
caller that traces one trip of a repeated body sets the counter's
``scale`` to the trip count while it runs. A loop of thousands of
trips of one shape (the mamba scan: one step a token) would take
minutes so; inside a counter made with ``sample_loops`` (``meta``
tensors only: the skipped trips' values are never read) it runs one
trip, whose ops forward and backward count once per trip
(:func:`loop_sampler`, :func:`counted_trips`, :func:`repeat_trips`),
as the reference counts a scan body times its trip count.

The counter also keeps the peak of live local bytes of the storages the
traced ops allocate (each storage counted once, freed when its last
tensor dies): the dry run's ``temp_size_in_bytes``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "all-to-all", "collective-permute")

# aten counterparts of the reference's _ELEMENTWISE HLO opcodes
_ELEMENTWISE_NAMES = (
    "add", "sub", "mul", "div", "maximum", "minimum", "exp", "tanh",
    "rsqrt", "sqrt", "log", "pow", "neg", "abs", "floor", "ceil", "sign",
    "cos", "sin", "sigmoid", "expm1", "log1p", "atan2", "remainder")

# functional collectives (what DTensor's redistributions issue)
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

# ops whose argument named here carries the bytes a scatter writes
_SCATTER_SRC = {"copy_": 1, "index_put_": 2, "index_put": 2,
                "index_copy_": 3, "index_copy": 3, "slice_scatter": 1,
                "select_scatter": 1, "scatter_": 3, "scatter": 3}


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    elementwise_flops: float = 0.0
    hbm_bytes: float = 0.0          # every op's inputs + outputs (upper)
    hbm_bytes_opt: float = 0.0      # the reference's optimistic estimate
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {k: {"count": 0.0, "bytes": 0.0,
                                     "wire_bytes": 0.0}
                                 for k in _COLLECTIVES})

    @property
    def total_flops(self) -> float:
        return self.flops + self.elementwise_flops

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c["wire_bytes"] for c in self.collectives.values())

    def to_json(self) -> dict:
        return {"dot_flops": self.flops,
                "elementwise_flops": self.elementwise_flops,
                "flops": self.total_flops,
                "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_opt": self.hbm_bytes_opt,
                "collective_wire_bytes": self.collective_wire_bytes,
                "collectives": self.collectives}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _flat(x) -> list:
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them, one level deep)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for a in x if isinstance(x, (list, tuple)) else ():
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(args, name: str) -> int:
    """The collective's group size: an argument of the op, else the
    process group its ``group_name`` argument names."""
    if name.startswith(("all_gather_into_tensor", "reduce_scatter_tensor")):
        for a in args[1:]:
            if isinstance(a, int) and not isinstance(a, bool):
                return a
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(group).size()


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Wire bytes per device of one collective (the reference's ring
    formulas, ``hlo_stats._collective_wire_bytes``)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "reduce-scatter":
        return frac * result_bytes * g
    if kind in ("all-gather", "all-to-all"):
        return frac * result_bytes
    return float(result_bytes)          # collective-permute


#: the innermost StepCounter, when it samples loops
_SAMPLER: contextvars.ContextVar = contextvars.ContextVar(
    "loop_sampler", default=None)


def loop_sampler(n: int):
    """The counter for which a loop of ``n`` trips of one shape runs one
    trip (:func:`counted_trips`), or ``None`` (run them all): a
    :class:`StepCounter` made with ``sample_loops`` is on, and ``n > 1``."""
    counter = _SAMPLER.get()
    return counter if counter is not None and n > 1 else None


def _rescale(counter, n: int, enter: bool) -> None:
    counter.scale = counter.scale * n if enter else counter.scale / n


class _TripEdge(torch.autograd.Function):
    """Identity on a trip's inputs (``enter``) or outputs: the counter's
    scale times ``n`` from the entering edge to the leaving one, forward
    and, in reverse, backward."""

    @staticmethod
    def forward(ctx, counter, n, enter, *xs):
        ctx.counter, ctx.n, ctx.enter = counter, n, enter
        _rescale(counter, n, enter)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _rescale(ctx.counter, ctx.n, not ctx.enter)
        return (None, None, None) + grads


def counted_trips(counter, n: int, fn, *inputs):
    """``fn(*inputs)`` (a tuple of tensors out), one trip of a loop of
    ``n`` trips of one shape, its ops counted ``n`` times forward and
    backward. Every tensor the trip reads that needs a gradient must be
    among ``inputs``. Autograd runs a trip's backward ops together (in
    reverse order of their making), between its edges."""
    ins = _TripEdge.apply(counter, n, True, *inputs)
    try:
        outs = fn(*ins)
    except BaseException:
        _rescale(counter, n, False)
        raise
    return _TripEdge.apply(counter, n, False, *outs)


class _Repeat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, dim, stack):
        ctx.dim, ctx.size, ctx.stack = dim, x.shape[dim], stack
        return (torch.stack if stack else torch.cat)([x] * n, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.select(ctx.dim, 0) if ctx.stack else g.narrow(
            ctx.dim, 0, ctx.size)
        return g, None, None, None


def repeat_trips(x: torch.Tensor, n: int, dim: int, *, stack: bool):
    """The outputs of ``n`` trips joined as the loop joins them
    (``torch.stack`` or ``torch.cat`` on ``dim``) where one trip ran:
    ``x`` n times, with the join's own counts; backward it hands one
    trip's slice of the gradient on, as the join's backward does (the
    other trips' backward is counted by :func:`counted_trips`)."""
    return _Repeat.apply(x, n, dim, stack)


class StepCounter(TorchDispatchMode):
    """Count the ops run inside it into :attr:`stats` (local shapes).

    Only ops with a ``meta`` result count (the dry run keeps every local
    shard there): DTensor's sharding propagation works out shard sizes
    with small host tensors while the mode is on, and those are not the
    step's. ``state``: tensors whose reads the optimistic byte count
    charges (parameters, optimizer state, cache; DTensors count by their
    local shard). ``scale``: the factor each count is added with,
    changeable while the mode is on (a loop body traced once stands for
    ``scale`` trips). ``sample_loops``: loops that ask
    (:func:`loop_sampler`) run one trip."""

    def __init__(self, state=(), *, sample_loops: bool = False):
        super().__init__()
        self.sample_loops = sample_loops
        from torch.utils.flop_counter import flop_registry
        self._dots = flop_registry
        self._elementwise = {getattr(torch.ops.aten, n + s)
                             for n in _ELEMENTWISE_NAMES for s in ("", "_")
                             if hasattr(torch.ops.aten, n + s)}
        self.stats = StepStats()
        self.scale = 1.0
        self._state = set()
        for t in _tensors(state):
            t = getattr(t, "_local_tensor", t)
            self._state.add(self._key(t))
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._seen: Dict[int, int] = {}
        self._views: Dict[object, bool] = {}
        self.read: set = set()          # storages of ``state`` read

    def __enter__(self):
        self._token = _SAMPLER.set(self if self.sample_loops else None)
        return super().__enter__()

    def __exit__(self, *exc):
        _SAMPLER.reset(self._token)
        return super().__exit__(*exc)

    def was_read(self, t: torch.Tensor) -> bool:
        """Whether a traced op read ``t`` (a ``state`` tensor; a DTensor
        by its local shard)."""
        return self._key(getattr(t, "_local_tensor", t)) in self.read

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _is_state(self, t: torch.Tensor) -> bool:
        return self._key(t) in self._state

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen or key in self._state:
            return
        nb = st.nbytes()
        self._seen[key] = nb
        self.live_bytes += nb
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat(out)
        if any(t.is_meta for t in outs):
            self._count(func, args, kwargs, outs, out)
        return out

    def _count(self, func, args, kwargs, outs, out) -> None:
        s, k = self.stats, self.scale
        packet = func._overloadpacket
        name = packet.__name__
        rb = sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        view = self._views.get(func)
        if view is None:
            view = self._views[func] = _is_view(func)
        if name == "wait_tensor" or view:
            return
        ins = _flat(args) + _flat(tuple(kwargs.values()))
        for t in ins:       # a view of state is read when something reads it
            key = self._key(t)
            if key in self._state:
                self.read.add(key)
        kind = _COLLECTIVE_KIND.get(name)
        if kind is not None:
            g = _group_size(args, name)
            c = s.collectives[kind]
            c["count"] += k
            c["bytes"] += k * rb
            c["wire_bytes"] += k * wire_bytes(kind, rb, g)
            s.hbm_bytes += k * rb
            s.hbm_bytes_opt += k * rb
            return
        s.hbm_bytes += k * (rb + sum(_nbytes(t) for t in ins))
        if packet in self._dots:
            s.flops += k * self._dots[packet](*args, **kwargs, out_val=out)
            s.hbm_bytes_opt += k * (rb + sum(_nbytes(t) for t in ins))
            return
        if packet in self._elementwise:
            s.elementwise_flops += k * sum(t.numel() for t in outs)
        src = _SCATTER_SRC.get(name)
        if src is not None and src < len(args):
            s.hbm_bytes_opt += k * 2.0 * sum(
                _nbytes(t) for t in _flat((args[src],)))
            return
        for t in ins:
            if self._is_state(t):
                s.hbm_bytes_opt += k * min(_nbytes(t), max(rb, 1))


def analyze(fn, *args, state=(), **kwargs) -> StepStats:
    """The :class:`StepStats` of one run of ``fn`` (the counterpart of
    ``hlo_stats.analyze`` on a compiled step)."""
    with StepCounter(state=state) as counter:
        fn(*args, **kwargs)
    return counter.stats

