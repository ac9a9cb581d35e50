"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821; unverified].

VLM: the vision frontend is a stub; input_specs() provides precomputed
patch/text embeddings of shape (batch, seq, d_model). 80L dense GQA.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern=("attn",),
    frontend="vision",
    tie_embeddings=False,
    rope_theta=1e6,
    source="arXiv:2404.16821 (unverified)",
)
