"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / CP;
counterpart of ``repro.sharding.rules``).

Every parameter leaf carries logical axis names (models/common.ArraySpec);
this module maps them onto the mesh:

  mesh axes:  ('pod', 'data', 'model')  multi-pod   /  ('data', 'model')

  'batch'                -> ('pod', 'data')      data parallelism
  'heads' 'mlp' 'vocab'  -> 'model'              tensor parallelism
  'expert'               -> 'model'              expert parallelism
  'embed'                -> ('pod','data') when FSDP (ZeRO-3), else replicated
  'kv_heads'             -> 'model' when divisible, else replicated (GQA)
  'seq'                  -> 'data' only for context-parallel decode
  everything else        -> replicated

Conflict resolution: a mesh axis may appear once per spec; dims are
resolved left to right with already-used axes skipped. Divisibility is
checked per leaf; non-divisible dims fall back to replication.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of names — written exactly as the reference's
``PartitionSpec``. The ``*_pspecs`` functions need only the mesh's axis
names and sizes (a :class:`~repro_torch.sharding.act.MeshShape` will do);
the ``*_shardings`` functions pair each spec with a ``DeviceMesh`` as a
:class:`NamedSharding`, whose ``placements`` are the DTensor form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.models.common import (is_spec, tree_leaves, tree_map,
                                      tree_map_specs)

from .act import Spec, as_shape, placements

Tree = Any


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    fsdp: bool = False                  # shard 'embed' over the data axes
    context_parallel: bool = False      # shard cache time axis over 'data'
    # logical -> candidate mesh axes (first fit wins, in order)
    table: Optional[Dict[str, Tuple[str, ...]]] = None

    def resolved_table(self, mesh) -> Dict[str, Tuple[str, ...]]:
        names = as_shape(mesh).axis_names
        batch_axes = tuple(a for a in ("pod", "data") if a in names)
        t = {
            "batch": batch_axes,
            "heads": ("model",),
            "kv_heads": ("model",),
            "mlp": ("model",),
            "vocab": ("model",),
            "expert": ("model",),
            "embed": batch_axes if self.fsdp else (),
            "seq": ("data",) if self.context_parallel else (),
        }
        if self.table:
            t.update(self.table)
        return t


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the counterpart of JAX's
    ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def _axis_size(mesh, axes: Sequence[str]) -> int:
    shape = as_shape(mesh).shape
    return math.prod(shape[a] for a in axes) if axes else 1


def _entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def pspec_for(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              rules: ShardingRules, mesh) -> Spec:
    """Spec for one leaf, with divisibility and conflict checks."""
    table = rules.resolved_table(mesh)
    names = as_shape(mesh).axis_names
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        cand = table.get(name, ()) if name else ()
        cand = tuple(a for a in cand if a in names and a not in used)
        if cand and dim % _axis_size(mesh, cand) == 0:
            used.update(cand)
            out.append(_entry(cand))
        else:
            out.append(None)
    return tuple(out)


def params_pspecs(spec_tree: Tree, rules: ShardingRules, mesh) -> Tree:
    return tree_map_specs(
        lambda s: pspec_for(s.logical, s.shape, rules, mesh), spec_tree)


def params_shardings(spec_tree: Tree, rules: ShardingRules, mesh) -> Tree:
    return tree_map_specs(
        lambda s: NamedSharding(mesh, pspec_for(s.logical, s.shape, rules,
                                                mesh)), spec_tree)


# --------------------------------------------------------------- activations
def batch_pspec(rules: ShardingRules, mesh, ndim: int, *,
                seq_axis: Optional[int] = None,
                batch_size: Optional[int] = None) -> Spec:
    """Spec for a batch-leading activation or input: batch over the DP
    axes; the sequence axis over 'data' under context parallelism."""
    shape = as_shape(mesh).shape
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    specs: list = [None] * ndim
    if batch_size is None or batch_size % _axis_size(mesh, batch_axes) == 0:
        specs[0] = _entry(batch_axes) if batch_axes else None
    elif "data" in shape and batch_size % shape["data"] == 0:
        specs[0] = "data"
    if rules.context_parallel and seq_axis is not None and specs[0] is None:
        specs[seq_axis] = "data"
    return tuple(specs)


def batch_shardings(batch_tree: Tree, rules: ShardingRules, mesh,
                    cfg=None) -> Tree:
    """Shardings for a train / prefill batch dict (tokens, embeds,
    labels)."""
    def one(leaf):
        nd = len(leaf.shape)
        return NamedSharding(mesh, batch_pspec(
            rules, mesh, nd, seq_axis=1 if nd >= 2 else None,
            batch_size=leaf.shape[0]))
    return tree_map(one, batch_tree)


def cache_pspecs(cache_tree: Tree, rules: ShardingRules, mesh,
                 cfg=None) -> Tree:
    """Specs for a decode cache tree, resolved by leaf name.

    KV leaves are [(NP,) B, T, KV, hd]: batch -> DP axes; time -> 'data'
    under context parallelism (batch=1); kv heads -> 'model' if
    divisible, else head_dim. Mamba leaves shard d_inner over 'model'.
    Every other leaf ('len', 'pages') is replicated.
    """
    shape_of = as_shape(mesh).shape
    batch_axes = tuple(a for a in ("pod", "data") if a in shape_of)
    model_sz = shape_of.get("model", 1)
    dp = max(_axis_size(mesh, batch_axes), 1)

    def walk(tree):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
                continue
            shape = tuple(v.shape)
            nd = len(shape)
            specs = [None] * nd
            if name in ("k", "v", "cross_k", "cross_v"):
                b_ax, t_ax, kv_ax, hd_ax = nd - 4, nd - 3, nd - 2, nd - 1
                if shape[b_ax] % dp == 0 and batch_axes:
                    specs[b_ax] = _entry(batch_axes)
                elif (rules.context_parallel and "data" in shape_of
                      and shape[t_ax] % shape_of["data"] == 0):
                    specs[t_ax] = "data"
                # TP on the cache: kv heads when divisible, else head_dim
                if shape[kv_ax] % model_sz == 0:
                    specs[kv_ax] = "model"
                elif shape[hd_ax] % model_sz == 0:
                    specs[hd_ax] = "model"
                out[name] = tuple(specs)
            elif name in ("conv", "h"):
                di_ax = nd - 2 if name == "h" else nd - 1
                b_ax = nd - 3
                if shape[b_ax] % dp == 0 and batch_axes:
                    specs[b_ax] = _entry(batch_axes)
                if shape[di_ax] % model_sz == 0:
                    specs[di_ax] = "model"
                out[name] = tuple(specs)
            else:
                out[name] = ()
        return out

    return walk(cache_tree)


def cache_shardings(cache_tree: Tree, rules: ShardingRules, mesh,
                    cfg=None) -> Tree:
    return tree_map(lambda s: NamedSharding(mesh, s),
                    cache_pspecs(cache_tree, rules, mesh, cfg))


def spec_str(spec: Spec) -> str:
    """A spec printed as JAX prints its ``PartitionSpec``."""
    return f"PartitionSpec{tuple(spec)!r}"


def explain(spec_tree: Tree, rules: ShardingRules, mesh) -> Dict[str, str]:
    """Human-readable leaf -> spec map (logged by the dry run)."""
    return {path: spec_str(pspec_for(s.logical, s.shape, rules, mesh))
            for path, s in tree_leaves(spec_tree) if is_spec(s)}
