"""llava-next-34b: VLM backbone (anyres tiling frontend is a stub —
``input_specs()`` supplies precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    vocab=64000,
    embeds_input=True,
    mlp="gated_silu",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
