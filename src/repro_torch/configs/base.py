"""Config schema of the PyTorch port: a copy of ``repro.configs.base``,
with port-only fields at its end.

The port imports nothing of ``repro``; ``tests/test_torch_package.py``
holds every field of this copy equal to the original and every port-only
field of the reference's archs at its default, which leaves the arch as
the reference defines it."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable", "LAYER_BLOCKS"]

# a ``layer_types`` entry -> the block that layer runs
LAYER_BLOCKS = {"attention": "attn", "mamba": "ssm"}


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Families: dense | moe | hybrid | ssm | vlm | audio.

    ``block`` selects the layer mixer: "attn" (transformer), "ssm"
    (Mamba2 SSD), "hymba" (parallel attn + ssm heads sharing one block).

    Port-only fields (each default leaves an arch unchanged):
    ``layer_types`` gives each layer its mixer ("mamba" or "attention",
    ``LAYER_BLOCKS``; empty: every layer is ``block``), and then every
    layer, Mamba or attention, is followed by the MLP or MoE sublayer;
    ``d_ff_shared`` a gated shared expert beside the routed ones;
    ``attn_scale`` the softmax scale (0: head_dim^-0.5); ``rope`` False
    drops the rotary embedding (NoPE); ``embed_scale`` multiplies the
    embedding's rows, ``residual_scale`` every sublayer's output before it
    is added, and the fp32 logits are divided by ``logit_scale``;
    ``dropless`` runs every routed assignment (no capacity).
    ``tie_embeddings`` uses the embedding as the head.
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
    # port-only (see the class docstring)
    layer_types: Tuple[str, ...] = ()
    d_ff_shared: int = 0
    attn_scale: float = 0.0
    rope: bool = True
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    dropless: bool = False

    def __post_init__(self):
        if self.layer_types:
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
            unknown = set(self.layer_types) - set(LAYER_BLOCKS)
            if unknown or len(self.layer_types) != self.num_layers:
                raise ValueError(f"{self.name}: layer_types needs {self.num_layers} entries of "
                                 f"{sorted(LAYER_BLOCKS)}, got {len(self.layer_types)} "
                                 f"(unknown {sorted(unknown)})")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.has_ssm and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    # -- derived -------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def layer_blocks(self) -> Tuple[str, ...]:
        """Each layer's block: "attn", "ssm" or "hymba"."""
        if self.layer_types:
            return tuple(LAYER_BLOCKS[t] for t in self.layer_types)
        return (self.block,) * self.num_layers

    @property
    def has_attention(self) -> bool:
        """Some layer attends."""
        return any(b in ("attn", "hymba") for b in self.layer_blocks)

    @property
    def has_ssm(self) -> bool:
        """Some layer runs the Mamba2 mixer."""
        return any(b in ("ssm", "hymba") for b in self.layer_blocks)

    def has_ffn(self, block: str) -> bool:
        """A layer of ``block`` is followed by the MLP or MoE sublayer: every
        layer of a ``layer_types`` arch, else the attention and hybrid
        layers of an arch with an MLP or experts."""
        return (bool(self.layer_types) or block in ("attn", "hymba")) and bool(
            self.d_ff or self.n_experts)

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM state or windowed KV)."""
        return all(b == "ssm" or (b == "hymba" and self.window > 0) for b in self.layer_blocks)

    def param_count(self) -> float:
        """Approximate parameter count (embedding + blocks + head)."""
        H = self.d_model
        # embeds-input archs (stub frontend) have no token-embedding table
        p = self.vocab * H * (1 if (self.tie_embeddings or self.embeds_input) else 2)
        return float(p + sum(self._layer_params(b) for b in self.layer_blocks))

    def _layer_params(self, block: str) -> int:
        H = self.d_model
        per_layer = 2 * H  # norms
        if block in ("attn", "hymba"):
            q = self.n_heads * self.head_dim
            kv = 2 * self.n_kv * self.head_dim
            per_layer += H * (q + kv) + q * H
        if block in ("ssm", "hymba"):
            d_in_proj = 2 * self.d_inner + 2 * self.ssm_state + self.ssm_n_heads
            per_layer += H * d_in_proj + self.d_inner * H + self.d_inner * self.conv_width
        if not self.has_ffn(block) and self.layer_types:
            return per_layer
        if self.n_experts:
            per_layer += self.n_experts * 3 * H * self.d_ff_expert + H * self.n_experts
            per_layer += 3 * H * self.d_ff_shared
        elif self.d_ff:
            mults = 3 if self.mlp == "gated_silu" else 2  # gate only when gated
            per_layer += mults * H * self.d_ff
        return per_layer

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
