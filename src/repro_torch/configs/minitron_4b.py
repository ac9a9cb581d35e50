"""minitron-4b — pruned nemotron, squared-relu MLP [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("attn",),
    activation="relu2",
    tie_embeddings=False,
    source="arXiv:2407.14679 (hf)",
)
