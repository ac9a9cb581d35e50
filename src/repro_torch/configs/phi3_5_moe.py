"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=16, top_k=2, every_n_layers=1),
    tie_embeddings=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct (hf)",
)
