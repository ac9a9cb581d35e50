"""qwen3-14b — qk_norm, GQA [hf:Qwen/Qwen3-8B family; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    layer_pattern=("attn",),
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (hf)",
)
