"""nemotron-4-340b: dense GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    d_ff=73728,
    vocab=256000,
    mlp="squared_relu",
    source="arXiv:2402.16819; unverified",
)
