"""The input-shape grid (the reference's ``repro.configs.shapes``): the
same four shapes for every LM arch. ``long_500k`` needs sub-quadratic
attention and applies only to SSM / hybrid / mostly-local archs
(``ArchConfig.subquadratic``)."""

from __future__ import annotations

from typing import Dict, List

from .base import ArchConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                       mode="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          mode="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         mode="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        mode="decode")

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(arch: ArchConfig) -> List[ShapeConfig]:
    """The shape cells that apply to this architecture."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.subquadratic:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(arch: ArchConfig) -> List[str]:
    return [] if arch.subquadratic else [LONG_500K.name]
