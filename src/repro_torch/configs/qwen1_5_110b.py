"""qwen1.5-110b — QKV bias [hf:Qwen/Qwen1.5 family; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    layer_pattern=("attn",),
    qkv_bias=True,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B config family (hf)",
)
