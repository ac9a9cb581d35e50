"""The port's architecture registry against the JAX package's: every
ported config and its ``.reduced()`` field by field (the parameter dtype
by name), the helpers the families need (``attention_free``,
``subquadratic``, ``layer_kinds``, ``moe_on_layer``, ``periods``), the
shape grid (``ALL_SHAPES``, ``shapes_for``, ``skipped_shapes_for``), and
``count_params`` with the leaf paths and shapes of each model's spec
tree — built from specs only, nothing allocated."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import ARCHS as J_ARCHS
from repro.configs import shapes_for as j_shapes_for
from repro.configs import skipped_shapes_for as j_skipped_for
from repro.models import build_model as jbuild
from repro.models import make_batch as jmake_batch
from repro.models.common import count_params as j_count
from repro.models.common import is_spec
from repro_torch.configs import (ALL_SHAPES, ARCHS, MoEConfig, SSMConfig,
                                 get_arch, shapes_for, skipped_shapes_for)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model, make_batch
from repro_torch.models.bridge import leaf_shapes
from repro_torch.models.common import count_params

PORTED = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "gemma3-1b", "minitron-4b",
          "qwen1.5-110b", "qwen3-14b", "falcon-mamba-7b",
          "jamba-1.5-large-398b", "whisper-small", "internvl2-76b")


def _variants(name):
    """(label, JAX config, port config): published, reduced, and for
    gemma3-1b the reduced config with two leftover layers."""
    j, t = J_ARCHS[name], get_arch(name)
    out = [("full", j, t), ("reduced", j.reduced(), t.reduced())]
    if name == "gemma3-1b":
        out.append(("leftover",
                    dataclasses.replace(j.reduced(), num_layers=8),
                    dataclasses.replace(t.reduced(), num_layers=8)))
    return out


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).split(".")[-1]
    return d


def test_registry_holds_every_attention_only_decoder():
    """Every decoder-only architecture: the attention-only ones and,
    since the recurrent slice, the mamba and hybrid ones; since the
    encoder-decoder slice the registry is the reference's whole."""
    assert sorted(ARCHS) == sorted(PORTED) == sorted(J_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("name", PORTED)
def test_configs_equal_reference_field_by_field(name):
    for label, j, t in _variants(name):
        assert _fields(t) == _fields(j), label


@pytest.mark.parametrize("name", PORTED)
def test_helpers_equal_reference(name):
    for label, j, t in _variants(name):
        assert t.attention_free == j.attention_free, label
        assert t.subquadratic == j.subquadratic, label
        assert t.layer_kinds() == j.layer_kinds(), label
        assert t.periods() == j.periods(), label
        assert t.resolved_head_dim == j.resolved_head_dim, label
        assert ([t.moe_on_layer(i) for i in range(t.num_layers)]
                == [j.moe_on_layer(i) for i in range(j.num_layers)]), label


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_helpers_on_every_reference_layout(name):
    """The helpers on the unported layouts too (mamba, hybrid, encoder-
    decoder, stub frontend), rebuilt as the port's config from the
    reference's fields."""
    j = J_ARCHS[name]
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    kw["moe"] = MoEConfig(**dataclasses.asdict(j.moe)) if j.moe else None
    kw["ssm"] = SSMConfig(**dataclasses.asdict(j.ssm)) if j.ssm else None
    t = ArchConfig(**kw)
    assert (t.attention_free, t.subquadratic, t.is_encdec) == (
        j.attention_free, j.subquadratic, j.is_encdec)
    assert t.layer_kinds() == j.layer_kinds()
    assert [s.name for s in shapes_for(t)] == [s.name for s in
                                               j_shapes_for(j)]
    assert skipped_shapes_for(t) == j_skipped_for(j)
    assert _fields(t.reduced()) == _fields(j.reduced())


def test_shape_grid_equals_reference():
    assert {k: dataclasses.asdict(v) for k, v in ALL_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert {k: v.tokens for k, v in ALL_SHAPES.items()} == {
        k: v.tokens for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("name", PORTED)
def test_shapes_for_equal_reference(name):
    for label, j, t in _variants(name):
        assert [dataclasses.asdict(s) for s in shapes_for(t)] == [
            dataclasses.asdict(s) for s in j_shapes_for(j)], label
        assert skipped_shapes_for(t) == j_skipped_for(j), label


def _j_leaf_shapes(spec_tree):
    flat = jax.tree_util.tree_flatten_with_path(spec_tree,
                                                is_leaf=is_spec)[0]
    return {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in flat}


@pytest.mark.parametrize("name", PORTED)
def test_count_params_and_spec_tree_equal_reference(name):
    """The published model's spec tree: same leaf paths and shapes, the
    same parameter count (nothing allocated on either side)."""
    for label, j, t in _variants(name):
        jspec, tspec = jbuild(j).spec_tree(), build_model(t).spec_tree()
        assert leaf_shapes(tspec) == _j_leaf_shapes(jspec), label
        assert count_params(tspec) == j_count(jspec), label


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", PORTED)
def test_make_batch_matches_reference_layout(name, mode):
    """The same keys, shapes and dtypes as the reference's batch, token
    ids in the vocabulary, the same draw from the same generator seed."""
    j, t = J_ARCHS[name].reduced(), get_arch(name).reduced()
    shape = dataclasses.replace(ALL_SHAPES["train_4k"], seq_len=16,
                                mode=mode)
    want = jmake_batch(j, shape, jax.random.PRNGKey(0), batch_override=3)
    got = make_batch(t, shape, torch.Generator().manual_seed(0),
                     batch_override=3)
    again = make_batch(t, shape, torch.Generator().manual_seed(0),
                       batch_override=3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert tuple(got[k].shape)[:2] == (
            3, t.decoder_len if t.is_encdec and k != "embeds" else 16)
        assert torch.equal(got[k], again[k])
        if k == "embeds":           # frames / patches: the model dtype
            assert got[k].dtype == t.dtype
            assert np.asarray(want[k]).dtype == np.float32
            continue
        assert got[k].dtype == torch.int32
        assert np.asarray(want[k]).dtype == np.int32
        assert 0 <= int(got[k].min()) and int(got[k].max()) < t.vocab_size


def test_model_zoo_refuses_the_unported_layouts():
    """whisper-small and internvl2-76b build since the encoder-decoder
    slice: the encoder-decoder as ``EncDecLM``, the stub frontend as an
    ``LM`` without token embeddings; both draw embedding batches. The
    layout nothing builds yet, an encoder-decoder handed to ``LM``
    directly, still raises."""
    from repro_torch.models import LM, EncDecLM
    for name in ("whisper-small", "internvl2-76b"):
        j = J_ARCHS[name]
        kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        kw["moe"], kw["ssm"] = None, None
        cfg = ArchConfig(**kw)
        model = build_model(cfg)
        assert isinstance(model, EncDecLM if cfg.is_encdec else LM)
        batch = make_batch(cfg, dataclasses.replace(
            ALL_SHAPES["train_4k"], seq_len=8), torch.Generator(
                ).manual_seed(0), batch_override=1)
        assert batch["embeds"].shape == (1, 8, cfg.d_model)
    with pytest.raises(ValueError, match="encoder-decoder"):
        LM(get_arch("whisper-small"))
