"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=64, top_k=8, every_n_layers=1),
    qk_norm=True,
    source="arXiv:2409.02060 (hf)",
)
