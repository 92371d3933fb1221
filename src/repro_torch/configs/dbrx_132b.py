"""dbrx-132b: fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base;
unverified]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    d_ff_expert=10752,
    mlp="gated_silu",
    source="hf:databricks/dbrx-base; unverified",
)
