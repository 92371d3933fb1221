"""minitron-4b: pruned nemotron, dense GQA [arXiv:2407.14679; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_ff=9216,
    vocab=256000,
    mlp="squared_relu",
    source="arXiv:2407.14679; hf",
)
