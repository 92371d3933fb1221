"""yi-6b: llama-arch dense GQA [arXiv:2403.04652; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    mlp="gated_silu",
    source="arXiv:2403.04652; hf",
)
