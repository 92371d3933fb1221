"""mamba2-2.7b: attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    block="ssm",
    ssm_state=128,
    ssm_headdim=64,
    d_inner=5120,
    source="arXiv:2405.21060; unverified",
)
