"""Carry the reference's weights into the port.

The reference's ``LM.init(key)`` returns a nested dict of arrays. A
caller turns it into numpy (``jax.tree_util.tree_map(np.asarray, p)``
— done by the tests, never here: this package does not import jax) and
:func:`params_from_numpy` places it on a device under the same tree
paths (``periods/layer_<j>/...`` with the leading stacked axis,
``leftover/...``). Every leaf must map to exactly one parameter of the
port's spec with the same shape, and every spec leaf must be covered.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .common import tree_leaves, tree_map


def leaf_shapes(tree) -> Dict[str, tuple]:
    """``{path: shape}`` of a nested dict of arrays, tensors or specs."""
    return {path: tuple(getattr(leaf, "shape"))
            for path, leaf in tree_leaves(tree)}


def check_matches(model, tree) -> None:
    """Raise unless ``tree``'s paths and shapes are exactly the model's
    parameter spec."""
    want = leaf_shapes(model.spec_tree())
    got = leaf_shapes(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {extra}")
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    if bad:
        raise ValueError(f"parameter shapes differ (got, want): {bad}")


def params_from_numpy(model, tree, device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) as the port's
    parameters on ``device``. Leaves keep the spec's dtype unless
    ``dtype`` overrides every floating leaf."""
    check_matches(model, tree)
    specs = dict(tree_leaves(model.spec_tree()))

    def convert(path_leaf):
        path, leaf = path_leaf
        leaf = np.asarray(leaf)
        if leaf.dtype.kind not in "fiub":
            # ml_dtypes' bfloat16 (what jax arrays become): widen to
            # float32, exactly, before torch narrows it again
            leaf = leaf.astype(np.float32)
        return torch.tensor(leaf, device=device,
                            dtype=dtype or specs[path].dtype)

    paired = _with_paths(tree)
    return tree_map(convert, paired)


def _with_paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _with_paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    return (prefix[:-1], tree)
