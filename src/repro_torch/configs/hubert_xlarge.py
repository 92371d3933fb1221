"""hubert-xlarge: encoder-only audio backbone (w2v2 arch; frame-embedding
frontend is a stub) [arXiv:2106.07447; unverified]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    embeds_input=True,
    mlp="gelu",
    source="arXiv:2106.07447; unverified",
)
