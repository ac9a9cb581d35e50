"""Elastic scaling: re-form the mesh after membership changes and
reshard (counterpart of ``repro.train.elastic``).

Recovery protocol at node failure:

  1. the coordinator's step barrier times out -> the straggler set is
     identified (the XF barrier's unset flags — core/coordinator);
  2. the failed hosts are evicted (membership epoch bump under the ticket
     mutex), a new mesh shape is chosen from the survivors;
  3. the latest *committed* checkpoint is restored onto the new mesh's
     shardings (checkpoint tensors are layout-agnostic npz) and training
     resumes at the checkpointed step.

``choose_mesh_shape`` prefers shrinking the data axis (pure-DP loss) and
keeps the model axis intact (re-sharding TP would change per-op shapes);
``reshard`` moves a host tree onto the new mesh as DTensors.
"""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_map

Tree = Any


def choose_mesh_shape(n_devices: int, model_parallel: int,
                      pods: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) grid fitting ``n_devices``, model
    fixed."""
    if n_devices % (model_parallel * pods):
        # degrade pods before degrading model parallelism
        pods = 1
    data = n_devices // (model_parallel * pods)
    if data < 1:
        raise ValueError(
            f"cannot fit model_parallel={model_parallel} on {n_devices}")
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def make_mesh_from_shape(shape: Tuple[int, ...]):
    """A ``DeviceMesh`` of ``shape`` over the running world."""
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes)


def reshard(tree: Tree, shardings: Tree) -> Tree:
    """Each leaf of a host (or device) tree as a DTensor on its
    ``NamedSharding`` (``sharding/rules.py``): every rank passes the same
    full tensor and keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return distribute_tensor(x.detach().to(s.mesh.device_type), s.mesh,
                                 list(s.placements))

    return tree_map(one, tree, shardings)


def survivors_mesh(alive: int, old_model: int,
                   pods: int = 1) -> Tuple[int, ...]:
    """Mesh for the surviving device count, keeping the TP degree."""
    usable = (alive // old_model) * old_model
    if usable == 0:
        raise ValueError("not enough survivors for one model replica")
    return choose_mesh_shape(usable, old_model, pods=pods)
