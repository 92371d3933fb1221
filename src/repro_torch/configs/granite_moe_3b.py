"""granite-moe-3b-a800m: MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    mlp="gated_silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
