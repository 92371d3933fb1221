"""Config registry: 10 assigned archs + the paper's Megatron T-series
(Table IV workloads: Narayanan et al. 2021 configs, seq 2048, vocab 51200).
``ARCHS`` is the reference's registry, arch for arch; ``PORT_ARCHS`` holds
the archs only the port runs, which ``get_config`` also resolves."""

from __future__ import annotations

from typing import Dict, List

from .base import ArchConfig
from .yi_6b import CONFIG as YI_6B
from .nemotron_4_340b import CONFIG as NEMOTRON
from .granite_3_8b import CONFIG as GRANITE
from .minitron_4b import CONFIG as MINITRON
from .hymba_1p5b import CONFIG as HYMBA
from .granite_moe_3b import CONFIG as GRANITE_MOE
from .dbrx_132b import CONFIG as DBRX
from .llava_next_34b import CONFIG as LLAVA
from .hubert_xlarge import CONFIG as HUBERT
from .mamba2_2p7b import CONFIG as MAMBA2
from .granite_4_h_small import CONFIG as GRANITE_4_H

__all__ = ["ARCHS", "PORT_ARCHS", "PAPER_MODELS", "get_config", "list_archs"]

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [YI_6B, NEMOTRON, GRANITE, MINITRON, HYMBA,
              GRANITE_MOE, DBRX, LLAVA, HUBERT, MAMBA2]
}

# archs of the port alone (fields the reference's schema lacks)
PORT_ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [GRANITE_4_H]}


def _t(name: str, layers: int, hidden: int, heads: int) -> ArchConfig:
    return ArchConfig(
        name=name, family="dense", num_layers=layers, d_model=hidden,
        n_heads=heads, n_kv=heads, d_ff=4 * hidden, vocab=51200,
        mlp="gelu", source="Megatron [28] / PALM Table IV",
    )


# Megatron model table (Narayanan et al. 2021) used by PALM Table IV/VII.
PAPER_MODELS: Dict[str, ArchConfig] = {
    "T-18B": _t("T-18B", 40, 6144, 48),
    "T-39B": _t("T-39B", 48, 8192, 64),
    "T-76B": _t("T-76B", 60, 10240, 80),
    "T-145B": _t("T-145B", 80, 12288, 96),
    "T-310B": _t("T-310B", 96, 16384, 128),
    "T-530B": _t("T-530B", 105, 20480, 128),
}


def get_config(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    # the reference's message, word for word (tests hold the two equal)
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(PAPER_MODELS)}")


def list_archs() -> List[str]:
    return sorted(ARCHS)
