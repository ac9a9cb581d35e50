"""whisper-small — enc-dec audio backbone; conv frontend stubbed
[arXiv:2212.04356; unverified]. input_specs() provides precomputed frame
embeddings; shapes apply to the encoder length (decode = decoder step with
cross-attention over seq_len encoder states)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=("attn",),
    activation="gelu",
    decoder_len=448,
    frontend="audio",
    rope_theta=10000.0,      # backbone uses learned pos in HF; RoPE stand-in
    source="arXiv:2212.04356 (unverified)",
)
