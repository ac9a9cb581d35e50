"""Parameter trees shared by every architecture (counterpart of
``repro.models.common``).

Parameters are nested dicts of tensors with the reference's tree paths
(``periods/layer_0/mixer/wq`` …, stacked over periods on a leading
axis). A model first builds a *spec tree* of :class:`ArraySpec` — shape,
dtype, initializer and **logical axis names** — from which, without
materializing weights:

  * :func:`init_params`  — weights drawn on the target device from an
                           explicit ``torch.Generator``;
  * :func:`shape_params` — ``meta`` tensors (no memory: the dry run);
  * :func:`logical_tree` — logical axes per leaf (``sharding/rules.py``
                           maps them onto the mesh).

The draw rules are the reference's: ``zeros``/``ones`` leaves are
constant, every other leaf is normal with std ``init_scale /
sqrt(fan_in)`` where ``fan_in`` is the leading dimension (the last one
for vectors). The two packages' random streams differ, so parity tests
carry the reference's weights across with :mod:`repro_torch.models.bridge`
instead.

Logical axis vocabulary (see ``sharding/rules.py`` for the mesh mapping):
  'batch' 'seq' 'embed' 'heads' 'kv_heads' 'head_dim' 'mlp' 'vocab'
  'expert' 'layer' (stacked leading axis) 'conv' 'state' 'dt'
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]
Logical = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Logical
    init: str = "normal"      # normal | zeros | ones
    init_scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape,
                                                      self.logical)


def spec(shape, logical, dtype=torch.bfloat16, init: str = "normal",
         scale: float = 1.0) -> ArraySpec:
    return ArraySpec(tuple(int(s) for s in shape), dtype, tuple(logical),
                     init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ArraySpec)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict (with ``rest``: to the
    leaves at the same paths of parallel trees, in ``tree``'s
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths joined with ``/``, in dict order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def sorted_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's flattening order: dict
    keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_map_specs(fn: Callable[[ArraySpec], Any], tree):
    return tree_map(fn, tree)


def shape_params(spec_tree):
    """``meta`` tensors of each leaf's shape and dtype — zero bytes
    allocated (the counterpart of ``jax.ShapeDtypeStruct``)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree)


def logical_tree(spec_tree):
    return tree_map_specs(lambda s: s.logical, spec_tree)


def stack_specs(tree, n: int):
    """Add a leading ``'layer'`` axis of size ``n`` (one entry per
    period)."""
    return tree_map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      logical=("layer",) + s.logical),
        tree)


def count_params(spec_tree) -> int:
    """Number of parameters of a spec tree (nothing is allocated)."""
    return sum(math.prod(s.shape) for _, s in tree_leaves(spec_tree))


def init_params(spec_tree, generator: torch.Generator,
                device) -> Tree:
    """Materialize a spec tree on ``device``. Normal leaves are drawn in
    float32 one leading slice at a time (a full-width stacked FFN leaf
    would otherwise need a float32 copy of the whole stack) and cast to
    the leaf's dtype."""
    device = torch.device(device)

    def one(s: ArraySpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[-1], 1)
        std = s.init_scale / math.sqrt(max(fan_in, 1))
        out = torch.empty(s.shape, dtype=s.dtype, device=device)
        rows = out.view(-1, *s.shape[-1:]) if len(s.shape) > 1 else out[None]
        step = max(1, (1 << 26) // max(rows.shape[1], 1))
        for r0 in range(0, rows.shape[0], step):
            part = rows[r0:r0 + step]
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device) * std)
        return out

    return tree_map(one, spec_tree)


def activation(name: str):
    if name in ("swiglu", "silu"):   # swiglu is gated at the MLP level
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":              # squared relu (nemotron/minitron)
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x
