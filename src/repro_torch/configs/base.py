"""Config schema of the PyTorch port: a copy of ``repro.configs.base``.

The port imports nothing of ``repro``; ``tests/test_torch_package.py``
holds every field of this copy equal to the original."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable"]


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Families: dense | moe | hybrid | ssm | vlm | audio.

    ``block`` selects the layer mixer: "attn" (transformer), "ssm"
    (Mamba2 SSD), "hymba" (parallel attn + ssm heads sharing one block).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    block: str = "attn"
    mlp: str = "gated_silu"               # gated_silu | squared_relu | gelu
    causal: bool = True                   # False for encoder-only (hubert)
    tie_embeddings: bool = False
    # attention variants
    window: int = 0                       # 0 = full attention; >0 sliding window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_headdim: int = 64
    d_inner: int = 0                      # 0 -> 2 * d_model
    conv_width: int = 4
    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embeds_input: bool = False
    source: str = ""                      # provenance tag from the assignment

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block in ("ssm", "hymba") and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    # -- derived -------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.block in ("attn", "hymba")

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM state or windowed KV)."""
        return self.block == "ssm" or (self.block == "hymba" and self.window > 0)

    def param_count(self) -> float:
        """Approximate parameter count (embedding + blocks + head)."""
        H, L = self.d_model, self.num_layers
        # embeds-input archs (stub frontend) have no token-embedding table
        p = self.vocab * H * (1 if (self.tie_embeddings or self.embeds_input) else 2)
        per_layer = 2 * H  # norms
        if self.has_attention:
            q = self.n_heads * self.head_dim
            kv = 2 * self.n_kv * self.head_dim
            per_layer += H * (q + kv) + q * H
        if self.block in ("ssm", "hymba"):
            d_in_proj = 2 * self.d_inner + 2 * self.ssm_state + self.ssm_n_heads
            per_layer += H * d_in_proj + self.d_inner * H + self.d_inner * self.conv_width
        if self.n_experts:
            per_layer += self.n_experts * 3 * H * self.d_ff_expert + H * self.n_experts
        elif self.d_ff:
            mults = 3 if self.mlp == "gated_silu" else 2  # gate only when gated
            per_layer += mults * H * self.d_ff
        return float(p + L * per_layer)

    @property
    def ssm_n_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_headdim) if self.d_inner else 0

    def active_param_count(self) -> float:
        """MoE: only top-k experts are active per token (for MODEL_FLOPS)."""
        if not self.n_experts:
            return self.param_count()
        H, L = self.d_model, self.num_layers
        inactive = (self.n_experts - self.top_k) * 3 * H * self.d_ff_expert
        return self.param_count() - L * inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch shape set)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str     # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec-mandated skips (see DESIGN.md §4)."""
    if shape.kind == "decode" and arch.is_encoder_only:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: 512k decode needs sub-quadratic attention"
    return True, ""
