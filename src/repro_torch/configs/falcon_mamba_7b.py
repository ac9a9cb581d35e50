"""falcon-mamba-7b — pure mamba1, attention-free [arXiv:2410.05355; unverified]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                  # mamba block subsumes the FFN
    vocab_size=65024,
    layer_pattern=("mamba",),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    source="arXiv:2410.05355 (unverified)",
)
