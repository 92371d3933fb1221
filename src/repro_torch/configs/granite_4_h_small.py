"""granite-4.0-h-small: 40 layers by pattern, 36 Mamba-2 and 4 NoPE GQA
attention layers (5, 15, 25, 35), each followed by a MoE of 72 gated-SiLU
experts (top 10, dropless) and a shared gated-SiLU expert; embedding x12,
every sublayer's output x0.22, logits / 16, head tied to the embedding
[hf:ibm-granite/granite-4.0-h-small, config.json; model_type
granitemoehybrid]. A port-only arch: the reference's registry has no
such model (``registry.PORT_ARCHS``)."""

from .base import ArchConfig

_ATTENTION = (5, 15, 25, 35)

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=0,
    vocab=100352,
    head_dim=128,
    block="ssm",
    mlp="gated_silu",
    tie_embeddings=True,
    n_experts=72,
    top_k=10,
    d_ff_expert=768,
    ssm_state=128,
    ssm_headdim=64,
    d_inner=8192,
    conv_width=4,
    source="hf:ibm-granite/granite-4.0-h-small",
    layer_types=tuple("attention" if i in _ATTENTION else "mamba" for i in range(40)),
    d_ff_shared=1536,
    attn_scale=0.0078125,
    rope=False,
    embed_scale=12.0,
    residual_scale=0.22,
    logit_scale=16.0,
    dropless=True,
)
