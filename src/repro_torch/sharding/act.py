"""Activation sharding constraints, context-scoped (counterpart of
``repro.sharding.act``).

Models call ``constrain_batch`` at the embedding boundary (and the MoE
dispatch ``constrain_expert_model`` / ``constrain_dispatch``, the
``'seq'`` head plan ``constrain_seq_model``, attention's core
``batch_heads_local``); a driver scopes the policy with
``activation_sharding(mesh, batch_axes)``, and runs with the policy
unset are untouched. The attention head plan reads the policy's
tensor-parallel degree (:func:`current_tp`), so spec trees built under
one policy and the code that applies them agree.

A mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh` or a
:class:`MeshShape` — axis names and sizes with no processes behind them,
enough to derive plans and specs for the 16 x 16 production geometry on
one machine. The torch meaning of a constraint: when ``x`` is a
``DTensor`` on the policy's ``DeviceMesh`` it is redistributed to the
placements the reference's ``PartitionSpec`` entries name; any other
tensor is returned unchanged.

XLA propagates a constraint backwards into the ops that feed it; DTensor
propagates placements forwards only, op by op. So where the reference
constrains an op's *result* and XLA then partitions the op itself (the
MoE dispatch, attention per head), the port pins the op's *inputs*
instead (``constrain_dispatch``, ``batch_heads_local``), so each device
computes only its part, as the partitioned HLO does; and the outputs of
the row-parallel projections (``wo``, an FFN's down projection, the MoE
combine) are pinned back to the batch placement with ``constrain_batch``
(an all-reduce of their partial sums), so the residual stream stays
replicated over 'model' from layer to layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)

#: one entry of a partition spec: replicated, one mesh axis, or several
#: (split major-to-minor in the order given)
Entry = Optional[object]
Spec = Tuple[Entry, ...]


class MeshShape:
    """Axis names and sizes of a mesh, in order (``{"data": 16, "model":
    16}``); ``shape`` and ``axis_names`` read as a JAX mesh's do."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        return f"MeshShape({self.shape})"


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    if _plain(x):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _plain(x) -> bool:
    """Whether ``x`` is a plain tensor: a helper's check that needs no
    ``DTensor`` import on the paths that run without a mesh."""
    return type(x) is torch.Tensor


def is_split(x, dim: int) -> bool:
    """Whether ``x`` is a ``DTensor`` split on its dim ``dim``."""
    if _plain(x):
        return False
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(x, DTensor) and Shard(dim) in x.placements


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def as_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a shape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    if is_device_mesh(mesh):
        return MeshShape(dict(zip(mesh.mesh_dim_names, mesh.shape)))
    if isinstance(mesh, dict):
        return MeshShape(mesh)
    # a duck-typed mesh: axis_names plus a {name: size} shape
    return MeshShape({a: mesh.shape[a] for a in mesh.axis_names})


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Sequence[str],
                        seq_axes: Sequence[str] = ()):
    """Scope the activation policy: batch dim -> ``batch_axes`` (and
    optionally the sequence dim -> ``seq_axes``, for context-parallel
    runs)."""
    token = _POLICY.set((mesh, tuple(batch_axes), tuple(seq_axes)))
    try:
        yield
    finally:
        _POLICY.reset(token)


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: (forward, recompute)
    context managers, the recompute scoped to the policy of the forward.
    The autograd engine runs a non-CPU device's backward, and so the
    recompute, on a thread of its own, where the policy's context
    variable is unset: without this the recompute would plan heads and
    constrain activations as if no mesh were there."""
    policy = _POLICY.get()
    if policy is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), activation_sharding(*policy)


def _spec_entry(axes: Tuple[str, ...]) -> Entry:
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _size(mesh, axes: Tuple[str, ...]) -> int:
    shape = as_shape(mesh).shape
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return max(n, 1)


def placements(mesh, spec: Spec):
    """DTensor placements of a partition spec on a mesh: for each mesh
    dimension ``Shard(d)`` when tensor dim ``d``'s entry names it, else
    ``Replicate()``. A dim split over several axes is split in mesh order
    (``("pod", "data")``: pod-major, as JAX splits it); an entry naming
    them out of mesh order has no DTensor form and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(as_shape(mesh).axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} splits dim {d} out of "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _constrain(x, mesh, entries, *, grad: bool = False) -> torch.Tensor:
    """``x`` redistributed to the placements of ``entries``. With
    ``grad`` its gradient is brought to them too: a gradient that
    arrives as partial sums (the sum of a residual's two branches) is
    all-reduced there, as the partitioned HLO does, instead of flowing
    on partial and making the next projection's backward gather its
    weight."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not is_device_mesh(mesh):
        return x
    want = placements(mesh, tuple(entries))
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    if grad and x.requires_grad:
        # from_local's backward redistributes the gradient to ``want``
        x = DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                               shape=x.shape, stride=x.stride())
    return x


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 (batch) of an activation to the configured data axes."""
    policy = _POLICY.get()
    if policy is None:
        return x
    mesh, batch_axes, seq_axes = policy
    if not batch_axes or x.shape[0] % _size(mesh, batch_axes) != 0:
        return _settle_partial(x)
    entries = [_spec_entry(batch_axes)] + [None] * (x.dim() - 1)
    if seq_axes and x.dim() >= 2 and x.shape[1] % _size(mesh, seq_axes) == 0:
        entries[1] = _spec_entry(seq_axes)
    return _constrain(x, mesh, entries, grad=True)


def _settle_partial(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` with pending sums reduced (replicated on those mesh
    dims), anything else as it is. The vocabulary-parallel embedding's
    masked partial may be reduced by one consumer only, so an activation
    that two ops read (the residual and its norm) is settled once here."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def current_tp() -> int:
    """Tensor-parallel degree of the active policy's mesh (1 when unset)
    — attention head planning keys off this."""
    policy = _POLICY.get()
    if policy is None:
        return 1
    return int(as_shape(policy[0]).shape.get("model", 1))


def constrain_expert_model(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 (experts) of the MoE dispatch tensors [E,B,C,D] to the
    'model' axis (and dim 1 to the batch axes), so an expert-parallel
    dispatch moves activations, not expert weights. The reference's
    ``REPRO_MOE_NO_EP_CONSTRAINT`` turns it off."""
    policy = _POLICY.get()
    if policy is None or os.environ.get("REPRO_MOE_NO_EP_CONSTRAINT"):
        return x
    mesh, batch_axes, _ = policy
    tp = as_shape(mesh).shape.get("model", 1)
    if tp <= 1 or x.shape[0] % tp != 0:
        return x
    entries = [None] * x.dim()
    entries[0] = "model"
    if (x.dim() >= 2 and batch_axes
            and x.shape[1] % _size(mesh, batch_axes) == 0):
        entries[1] = _spec_entry(batch_axes)
    return _constrain(x, mesh, entries)


def constrain_seq_model(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 1 (sequence) of an attention activation to the 'model'
    axis — the 'seq' head plan's sharding (batch dim 0 stays on the data
    axes)."""
    policy = _POLICY.get()
    if policy is None:
        return x
    mesh, batch_axes, _ = policy
    shape = as_shape(mesh).shape
    if "model" not in shape or x.dim() < 2:
        return x
    if x.shape[1] % shape["model"] != 0:
        return x
    entries = [None] * x.dim()
    if batch_axes and x.shape[0] % _size(mesh, batch_axes) == 0:
        entries[0] = _spec_entry(batch_axes)
    entries[1] = "model"
    return _constrain(x, mesh, entries)


def constrain_dispatch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 2 (experts) of the MoE routing tensors [B,S,E,C] to the
    'model' axis (and dim 0 to the batch axes), the input-side form of
    :func:`constrain_expert_model`: the dispatch and combine einsums
    then run on each device's experts only. Off under
    ``REPRO_MOE_NO_EP_CONSTRAINT``, as that constraint is."""
    policy = _POLICY.get()
    if policy is None or os.environ.get("REPRO_MOE_NO_EP_CONSTRAINT"):
        return x
    mesh, batch_axes, _ = policy
    tp = as_shape(mesh).shape.get("model", 1)
    if tp <= 1 or x.dim() < 3 or x.shape[2] % tp != 0:
        return x
    entries = [None] * x.dim()
    entries[2] = "model"
    if batch_axes and x.shape[0] % _size(mesh, batch_axes) == 0:
        entries[0] = _spec_entry(batch_axes)
    return _constrain(x, mesh, entries)


def batch_heads_local(fn, q: torch.Tensor, *rest):
    """``fn(q, *rest)`` for an op that is independent across batch rows
    and heads (attention's core; q and the 4-d inputs [B, T, H, hd]).
    With a ``DTensor`` ``q`` under the policy, each device runs ``fn`` on
    its own rows and heads — dim 0 on the batch axes and dim 2 on
    'model' where they divide, any other ``DTensor`` input replicated —
    and the result, of ``q``'s shape, keeps those placements. A cache
    split on head_dim (kv heads that do not divide the model axis) is
    contracted on its shards instead: gathering it whole each step would
    move the cache, so ``q`` is replicated over 'model', DTensor
    partitions the einsums (partial scores, all-reduced) and the result
    is split on its heads again. Otherwise ``fn`` runs as it is."""
    policy = _POLICY.get()
    if policy is None or _plain(q):
        return fn(q, *rest)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, *rest)
    mesh = q.device_mesh
    _, batch_axes, _ = policy
    entries = [None] * q.dim()
    if batch_axes and q.shape[0] % _size(mesh, batch_axes) == 0:
        entries[0] = _spec_entry(batch_axes)
    if any(isinstance(x, DTensor) and x.dim() == q.dim()
           and Shard(x.dim() - 1) in x.placements for x in rest):
        out = fn(_constrain(q, mesh, entries), *rest)
        tp = as_shape(mesh).shape.get("model", 1)
        if tp > 1 and out.shape[2] % tp == 0:
            entries[2] = "model"
        return _constrain(out, mesh, entries)
    tp = as_shape(mesh).shape.get("model", 1)
    if tp > 1 and q.shape[2] % tp == 0:
        entries[2] = "model"
    want = placements(mesh, tuple(entries))

    def local(x):
        if not isinstance(x, DTensor):
            return x
        pl = want if x.dim() == q.dim() else (Replicate(),) * mesh.ndim
        if tuple(x.placements) != pl:
            x = x.redistribute(mesh, pl)
        return x.to_local()

    out = fn(*(local(x) for x in (q,) + rest))
    stride = torch.empty(q.shape, device="meta").stride()
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=q.shape, stride=stride)


def seq_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``fn(q, k, v, q_offset=0)`` for attention whose queries are split
    on the sequence over 'model' (the ``'seq'`` head plan's band): with a
    ``DTensor`` ``q`` under the policy each device runs ``fn`` on its own
    batch rows and query positions, against its rows' whole K/V, with
    ``q_offset`` its first position; the result keeps ``q``'s split.
    DTensor would otherwise flatten two split dims (batch and sequence)
    into one batched matmul, which not every torch can."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    policy = _POLICY.get()
    if policy is None or not isinstance(q, DTensor):
        return fn(q, k, v, q_offset=0)
    mesh = q.device_mesh
    _, batch_axes, _ = policy
    shape = as_shape(mesh).shape
    rows = [None] * q.dim()
    if batch_axes and q.shape[0] % _size(mesh, batch_axes) == 0:
        rows[0] = _spec_entry(batch_axes)
    entries = list(rows)
    if "model" in shape and q.shape[1] % shape["model"] == 0:
        entries[1] = "model"
    want = placements(mesh, tuple(entries))
    ql = (q.redistribute(mesh, want) if tuple(q.placements) != want
          else q).to_local()
    # each device reads its rows' whole K/V for its own queries: their
    # gradients are partial sums over the query shards
    grads = tuple(Partial() if isinstance(p, Shard) and p.dim == 1 else p
                  for p in want)
    kv = [_constrain(x, mesh, rows).to_local(grad_placements=grads)
          for x in (k, v)]
    offset = 0
    if entries[1] == "model":
        axis = as_shape(mesh).axis_names.index("model")
        offset = (mesh.get_coordinate() or [0] * mesh.ndim)[axis] \
            * ql.shape[1]
    out = fn(ql, *kv, q_offset=offset)
    stride = torch.empty(q.shape, device="meta").stride()
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=q.shape, stride=stride)


def rows_local(fn, x: torch.Tensor, *weights):
    """``fn(x, *weights)`` for a per-row op (a projection) on ``x`` [B,
    S, ...] split on its batch and sequence dims only: with a ``DTensor``
    ``x``, each device applies ``fn`` to its own rows with the weights
    whole (gathered if sharded), and the result keeps ``x``'s split. A
    weight's gradient is then a partial sum over the split dims. DTensor
    would otherwise flatten the two split dims into one matmul, which not
    every torch can."""
    if _plain(x):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim == 1 for p in x.placements):
        return fn(x, *weights)
    mesh, pl = x.device_mesh, tuple(x.placements)
    full = (Replicate(),) * mesh.ndim
    grads = tuple(Partial() if isinstance(p, Shard) else Replicate()
                  for p in pl)
    ws = [(w if tuple(w.placements) == full else w.redistribute(mesh, full)
           ).to_local(grad_placements=grads) for w in weights]
    out = fn(x.to_local(), *ws)
    shape = torch.Size(tuple(x.shape[:2]) + tuple(out.shape[2:]))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=stride)


def constrain_flat_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Pin a head projection's flat product [B, S, H*K] before it is split
    into heads: dim 0 on the batch axes, the last dim on 'model' when the
    H heads divide over it, else replicated. DTensor may otherwise shard
    the flat axis of a product whose weight is replicated (kv heads that
    do not divide the model axis), and then cannot split it into H
    heads."""
    policy = _POLICY.get()
    if policy is None:
        return x
    mesh, batch_axes, _ = policy
    entries = [None] * x.dim()
    if batch_axes and x.shape[0] % _size(mesh, batch_axes) == 0:
        entries[0] = _spec_entry(batch_axes)
    tp = as_shape(mesh).shape.get("model", 1)
    if tp > 1 and n_heads % tp == 0:
        entries[-1] = "model"
    return _constrain(x, mesh, entries)


def unit_axes_replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its shards over mesh axes of size 1 read as replicas
    (the same data, so no communication): DTensor refuses to merge a
    dim sharded over such an axis with its neighbour (a single kv head
    on a (1, 1) mesh)."""
    if _plain(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pl = tuple(Replicate() if mesh.size(i) == 1 else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


def grad_as_value(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, with its gradient brought to ``x``'s placements (a
    flattened weight's gradient must split back into its heads)."""
    if _plain(x):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def local_apply(fn, x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``fn(x)``, which resizes ``x``'s dim ``dim`` to ``size`` and
    touches no other, on each shard of a ``DTensor`` not split on that
    dim (no communication, and no sharding rule needed for ``fn``'s
    ops); any other ``x`` as it is."""
    if _plain(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or Shard(dim) in x.placements:
        return fn(x)
    shape = list(x.shape)
    shape[dim] = size
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(fn(x.to_local()), x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_update(fn, dst: torch.Tensor, dim: int, *args) -> torch.Tensor:
    """``fn(dst, *args)``, a write into ``dst`` in place along its dim
    ``dim``, on each device's shard: with a ``DTensor`` ``dst`` not
    split on ``dim``, each ``DTensor`` argument of ``dst``'s rank is
    brought to ``dst``'s placements and any other replicated, and ``fn``
    writes the local shard (a write along an unsplit dim is local; and
    not every torch has a sharding rule for the write, ``index_copy_``
    among them). Returns ``dst``."""
    if _plain(dst):
        fn(dst, *args)
        return dst
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor) or Shard(dim) in dst.placements:
        fn(dst, *args)
        return dst
    mesh, pl = dst.device_mesh, tuple(dst.placements)

    def local(x):
        if not isinstance(x, DTensor):
            return x
        want = pl if x.dim() == dst.dim() else (Replicate(),) * mesh.ndim
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()

    fn(dst.to_local(), *(local(a) for a in args))
    return dst


def split_update_slice(dst: torch.Tensor, dim: int, start: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """``dst[start:start + S] = val`` along ``dim``, in place, for a
    ``DTensor`` ``dst`` split on ``dim`` (a context-parallel cache split
    on time): ``val`` is replicated over the split and brought to
    ``dst``'s other placements, and each device writes its own shard
    (torch has no sharding rule for a write along a split dim). The write
    is branch-free: every shard writes S positions clamped into its
    range, each with the value that belongs there, ``val``'s or the one
    it holds. ``start`` is clamped already so the slice fits. Returns
    ``dst``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    splits = [i for i, p in enumerate(pl) if p == Shard(dim)]
    want = tuple(Replicate() if i in splits else p for i, p in enumerate(pl))

    def local(x, placements):
        if not isinstance(x, DTensor):
            return x
        if tuple(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        return x.to_local()

    v = local(val, want)
    t0 = local(start, (Replicate(),) * mesh.ndim).long().reshape(())
    out = dst.to_local()
    n, s = out.shape[dim], v.shape[dim]
    if dst.shape[dim] != n * math.prod(mesh.size(i) for i in splits):
        raise ValueError(f"dim {dim} of {tuple(dst.shape)} does not divide "
                         f"over mesh dims {splits}")
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    shard = 0
    for i in splits:                      # mesh order: major to minor
        shard = shard * mesh.size(i) + coord[i]
    offset = shard * n
    tgt = (t0 + torch.arange(s, device=out.device) - offset).clamp(0, n - 1)
    j = tgt + offset - t0                 # val's index for that position
    has = ((j >= 0) & (j < s)).reshape(
        [1] * dim + [s] + [1] * (out.dim() - dim - 1))
    new = torch.where(has, v.index_select(dim, j.clamp(0, s - 1)).to(
        out.dtype), out.index_select(dim, tgt))
    out.index_copy_(dim, tgt, new)
    return dst


def vocab_parallel_log_prob(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[..., labels]`` for a ``DTensor`` ``logits``
    [..., V] that may be split on V: each device works on its shard of
    the vocabulary, and the max, the sum of exponentials and the picked
    logit are reduced across the shards (the all-reduces of a
    vocabulary-parallel loss; torch's ``loss_parallel`` takes only a
    one-dimensional mesh in some versions). The result [...] keeps the
    batch placements and is replicated over the vocabulary's axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.dim() - 1
    pl = tuple(logits.placements)
    vdims = [i for i, p in enumerate(pl) if p == Shard(last)]
    out_pl = tuple(Replicate() if i in vdims else p for i, p in enumerate(pl))
    shape = logits.shape[:-1]
    stride = torch.empty(shape, device="meta").stride()

    def reduced(local, op):
        part = tuple(Partial(op) if i in vdims else p
                     for i, p in enumerate(out_pl))
        return DTensor.from_local(local, mesh, part, run_check=False,
                                  shape=shape, stride=stride
                                  ).redistribute(mesh, out_pl).to_local()

    if tuple(labels.placements if isinstance(labels, DTensor) else ()) \
            != out_pl and isinstance(labels, DTensor):
        labels = labels.redistribute(mesh, out_pl)
    lab = labels.to_local() if isinstance(labels, DTensor) else labels
    x = logits.to_local()
    v = x.shape[-1]
    # each shard's first label is shard * v: equal shards only (torch's
    # chunk split leaves the last one short when V does not divide)
    if logits.shape[-1] != v * math.prod(mesh.size(i) for i in vdims):
        raise ValueError(f"vocabulary {logits.shape[-1]} does not divide "
                         f"over mesh dims {vdims}")
    m = reduced(x.detach().amax(dim=-1), "max")
    z = x - m[..., None]
    lse = torch.log(reduced(torch.exp(z).sum(dim=-1), "sum"))
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    shard = 0
    for i in vdims:                       # mesh order: major to minor
        shard = shard * mesh.size(i) + coord[i]
    rel = lab.long() - shard * v
    inside = (rel >= 0) & (rel < v)
    picked = torch.gather(z, -1, rel.clamp(0, v - 1)[..., None])[..., 0]
    ll = reduced(torch.where(inside, picked, torch.zeros_like(picked)),
                 "sum") - lse
    return DTensor.from_local(ll, mesh, out_pl, run_check=False,
                              shape=shape, stride=stride)
