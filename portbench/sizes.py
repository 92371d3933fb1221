"""A configuration's sizes as the benchmark reads them: the ``arch`` group
of its file, with the sizes that follow from it worked out here (the
yardstick takes nothing of the port, not even its config class)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Sizes:
    name: str
    family: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    block: str = "attn"
    mlp: str = "gated_silu"
    causal: bool = True
    window: int = 0
    n_experts: int = 0
    ssm_state: int = 0
    ssm_headdim: int = 64
    d_inner: int = 0
    conv_width: int = 4
    embeds_input: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block in ("ssm", "hymba") and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    @property
    def has_attention(self) -> bool:
        return self.block in ("attn", "hymba")

    @property
    def ssm_n_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_headdim) if self.d_inner else 0


def sizes_of(config: Dict) -> Sizes:
    """The ``Sizes`` of a configuration file."""
    return Sizes(**{k: v for k, v in config["arch"].items() if k in Sizes.__dataclass_fields__})


def block_sizes(config: Dict, sz: Sizes) -> Dict:
    """What the reference's block of this family needs beside its leaves."""
    if sz.block == "ssm":
        return {"d_inner": sz.d_inner, "d_state": sz.ssm_state, "headdim": sz.ssm_headdim,
                "d_conv": sz.conv_width}
    if sz.block == "attn":
        return {"heads": sz.n_heads, "kv_heads": sz.n_kv, "head_dim": sz.head_dim,
                "rope_theta": float(config["rope_theta"])}
    raise NotImplementedError(f"no reference block for {sz.block!r}")
