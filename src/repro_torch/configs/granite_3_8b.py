"""granite-3-8b: dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=12800,
    vocab=49155,
    mlp="gated_silu",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
