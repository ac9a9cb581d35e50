"""Weights from the seed, made by the benchmark and handed to both the
program and the reference.

The tree has the port's paths and layout (``periods/layer_0/...``
stacked over the layers on a leading axis); its sizes come from the
configuration file alone. Each matrix is drawn whole, in one call on
the device, in the dtype it is served in, as normal with std
``1 / sqrt(fan-in)`` of the matrix it holds (the embedding: std 1);
norm scales are 1.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Tree = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def layout(dm: Dict[str, Any]) -> Dict[str, Tuple[tuple, str, float]]:
    """``{path: (shape, dtype name, std)}``; std 0 means a scale of
    ones."""
    L, d, h, kv, hd = (dm["layers"], dm["d"], dm["heads"], dm["kv_heads"],
                       dm["hd"])
    ff, V, dt = dm["ff"], dm["vocab"], dm["dtype"]
    lay = "periods/layer_0/"
    out = {
        lay + "ln1/scale": ((L, d), "float32", 0.0),
        lay + "mixer/wq": ((L, d, h, hd), dt, d ** -0.5),
        lay + "mixer/wk": ((L, d, kv, hd), dt, d ** -0.5),
        lay + "mixer/wv": ((L, d, kv, hd), dt, d ** -0.5),
        lay + "mixer/wo": ((L, h, hd, d), dt, (h * hd) ** -0.5),
        lay + "ln2/scale": ((L, d), "float32", 0.0),
        "final_norm/scale": ((d,), "float32", 0.0),
        "embed/tokens": ((V, d), dt, 1.0),
    }
    if dm["qk_norm"]:
        out[lay + "mixer/q_norm/scale"] = ((L, hd), "float32", 0.0)
        out[lay + "mixer/k_norm/scale"] = ((L, hd), "float32", 0.0)
    if dm["experts"]:
        E = dm["experts"]
        out[lay + "ffn/router"] = ((L, d, E), "float32", d ** -0.5)
        out[lay + "ffn/gate"] = ((L, E, d, ff), dt, d ** -0.5)
        out[lay + "ffn/up"] = ((L, E, d, ff), dt, d ** -0.5)
        out[lay + "ffn/down"] = ((L, E, ff, d), dt, ff ** -0.5)
    elif dm["activation"] == "swiglu":
        out[lay + "ffn/gate"] = ((L, d, ff), dt, d ** -0.5)
        out[lay + "ffn/up"] = ((L, d, ff), dt, d ** -0.5)
        out[lay + "ffn/down"] = ((L, ff, d), dt, ff ** -0.5)
    else:
        out[lay + "ffn/in"] = ((L, d, ff), dt, d ** -0.5)
        out[lay + "ffn/out"] = ((L, ff, d), dt, ff ** -0.5)
    if not dm["tied"]:
        out["lm_head/kernel"] = ((d, V), dt, d ** -0.5)
    return out


def make(dm: Dict[str, Any], seed: int, device) -> Tree:
    """The nested weight tree for the sizes ``dm`` from ``seed``, drawn on
    ``device`` from its own generator, matrix by matrix in path order."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    tree: Tree = {}
    for path, (shape, dtype, std) in sorted(layout(dm).items()):
        dt = _DTYPES[dtype]
        if std == 0.0:
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=dt, device=device)
            leaf.mul_(std)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def leaves(tree: Tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def check_against(tree: Tree, spec_leaves) -> None:
    """Raise unless ``tree`` has exactly the program's parameter paths,
    shapes and dtypes (``spec_leaves``: ``(path, ArraySpec)`` pairs)."""
    mine = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}
    theirs = {p: (tuple(s.shape), s.dtype) for p, s in spec_leaves}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"weight tree differs from the program's: {diff}")
