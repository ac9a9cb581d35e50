"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]. Period of 8 layers: 1 attention + 7 mamba; MoE FFN
on every other layer (16 experts, top-2), dense FFN elsewhere."""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=("attn", "mamba", "mamba", "mamba",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, every_n_layers=2),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    tie_embeddings=False,
    source="arXiv:2403.19887 (hf)",
)
