"""The port's input specs against the JAX package's: ``batch_specs``,
``decode_token_spec`` and ``cache_specs`` give ``meta`` tensors of the
reference's ``ShapeDtypeStruct`` shapes and dtypes, leaf by leaf, for
every architecture and every shape cell that applies to it."""

import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import ALL_SHAPES as J_SHAPES
from repro.models import batch_specs as j_batch_specs
from repro.models import build_model as jbuild
from repro.models import cache_specs as j_cache_specs
from repro.models import decode_token_spec as j_token_spec
from repro_torch.configs import ALL_SHAPES, ARCHS, shapes_for
from repro_torch.models import (batch_specs, build_model, cache_specs,
                                decode_token_spec)
from repro_torch.models.common import sorted_leaves

CELLS = [(a, s.name) for a in sorted(ARCHS) for s in shapes_for(ARCHS[a])]


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _j_leaves(tree, prefix=""):
    """(path, ShapeDtypeStruct) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _j_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _same(port_tree, ref_tree):
    got = [(p, tuple(t.shape), _dtype_name(t.dtype))
           for p, t in sorted_leaves(port_tree)]
    want = [(p, tuple(int(d) for d in s.shape), np.dtype(s.dtype).name)
            for p, s in _j_leaves(ref_tree)]
    assert got == want
    for _, t in sorted_leaves(port_tree):
        assert t.device.type == "meta"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_the_reference(arch, shape):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    shp, jshp = ALL_SHAPES[shape], J_SHAPES[shape]
    if shp.mode in ("train", "prefill"):
        _same(batch_specs(cfg, shp), j_batch_specs(jcfg, jshp))
    else:
        tok, jtok = decode_token_spec(cfg, shp), j_token_spec(jcfg, jshp)
        _same({"t": tok}, {"t": jtok})
        _same(cache_specs(cfg, shp, build_model(cfg)),
              j_cache_specs(jcfg, jshp, jbuild(jcfg)))
