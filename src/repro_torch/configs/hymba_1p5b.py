"""hymba-1.5b: hybrid — parallel attention + mamba heads per block
[arXiv:2411.13676; hf].

Executable model uses sliding-window attention in every block (the SSM
path carries global context, per the Hymba design); the reference model's
3 global-attention layers are kept in the PALM workload IR but not the
homogeneous scanned JAX stack — see DESIGN.md §4.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    block="hymba",
    window=1024,
    ssm_state=16,
    ssm_headdim=64,
    mlp="gated_silu",
    source="arXiv:2411.13676; hf",
)
