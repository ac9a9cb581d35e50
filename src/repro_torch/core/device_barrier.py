"""Device-level synchronization over ``torch.distributed``: the cluster
analogue of the paper (counterpart of ``repro.core.device_barrier``).

The paper asked vendors for a hardware global barrier
(``__syncblocks()``). Across ranks a one-element all-reduce is that
barrier: every rank blocks until every rank arrives. This module gives
that barrier plus the collective *schedules* the paper's design rule
implies:

  principle (paper)                      collective schedule (here)
  -------------------------------------  --------------------------------
  bound the serializing ops per op       one fused all-reduce per step,
                                         not one per tensor
  front-load atomics, then poll          reduce-scatter early -> compute on
                                         shards -> all-gather late
  decentralize: own your word            hierarchical: reduce inside the pod
                                         first (fast links), cross-pod on
                                         shards only (slow links)

The reference runs these inside ``shard_map`` with ``jax.lax``
collectives; here each rank calls them on its own tensors with the
process groups of a ``DeviceMesh``'s dimensions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def global_device_barrier(mesh, axis_names: Optional[Sequence[str]] = None):
    """A barrier over the named dimensions of ``mesh`` (all of them by
    default): returns ``token -> token``, a one-element all-reduce (sum)
    over each named dimension's group in turn, so on every rank the
    result is the token times the number of ranks it spans."""
    names = tuple(axis_names or mesh.mesh_dim_names)
    groups = [mesh.get_group(a) for a in names]

    def barrier(token: torch.Tensor) -> torch.Tensor:
        t = token.clone()
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    return barrier


def hierarchical_psum(x: torch.Tensor, intra_group,
                      inter_group=None) -> torch.Tensor:
    """Reduce-scatter on the fast (intra-pod) group, all-reduce the shard
    on the slow (cross-pod) group, then all-gather on the fast group. For
    an N-byte tensor the slow links carry N/|intra| bytes — the
    "front-load the serializing op, then work on your own shard" rule.
    ``x``'s leading dim must divide by the intra group's size."""
    x = x.contiguous()
    if inter_group is None:
        out = x.clone()
        dist.all_reduce(out, group=intra_group)
        return out
    n = dist.get_world_size(intra_group)
    shard = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(shard, x, group=intra_group)
    dist.all_reduce(shard, group=inter_group)
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, shard, group=intra_group)
    return out


def make_hierarchical_allreduce(mesh, *, intra_axis: str = "data",
                                inter_axis: Optional[str] = None):
    """The hierarchical all-reduce of one flat vector held alike on every
    rank: its sum over ``intra_axis`` (and ``inter_axis``, when the mesh
    has it) — ``v x |intra| (x |inter|)``. The vector's length must
    divide by ``|intra_axis|``; the training loop pads once when it
    flattens the parameters, not per step."""
    names = mesh.mesh_dim_names
    intra = mesh.get_group(intra_axis)
    inter = (mesh.get_group(inter_axis)
             if inter_axis and inter_axis in names else None)

    def allreduce(v: torch.Tensor) -> torch.Tensor:
        return hierarchical_psum(v, intra, inter)

    return allreduce
