"""Activation sharding constraints, context-scoped (counterpart of
``repro.sharding.act``).

Models call ``constrain_batch`` at the embedding boundary (and the MoE
dispatch ``constrain_expert_model``, the ``'seq'`` head plan
``constrain_seq_model``); a driver scopes the policy with
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
"""

from __future__ import annotations

import contextlib
import contextvars
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


def _constrain(x, mesh, entries) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not is_device_mesh(mesh):
        return x
    want = placements(mesh, tuple(entries))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 (batch) of an activation to the configured data axes."""
    policy = _POLICY.get()
    if policy is None:
        return x
    mesh, batch_axes, seq_axes = policy
    if not batch_axes or x.shape[0] % _size(mesh, batch_axes) != 0:
        return x
    entries = [_spec_entry(batch_axes)] + [None] * (x.dim() - 1)
    if seq_axes and x.dim() >= 2 and x.shape[1] % _size(mesh, seq_axes) == 0:
        entries[1] = _spec_entry(seq_axes)
    return _constrain(x, mesh, entries)


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
