"""gemma3-1b — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    # 5 local (sliding-window 512) : 1 global, repeated over depth.
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=512,
    qk_norm=True,
    rope_theta=1e6,
    activation="geglu",
    scale_embeddings=True,
    source="hf:google/gemma-3-1b-pt (unverified)",
)
