"""Training launcher of the port. Only ``scale_arch`` so far: a copy of
``repro.launch.train.scale_arch``, whose module imports jax. The training
loop joins it with the training slice."""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig

__all__ = ["scale_arch"]


def scale_arch(arch: ArchConfig, scale: str) -> ArchConfig:
    """Family-preserving reductions for CPU-scale runs."""
    if scale == "full":
        return arch
    dims = {"tiny": (2, 128, 4, 256), "small": (4, 256, 8, 1024)}[scale]
    L, H, nh, V = dims
    nkv = max(1, min(arch.n_kv, nh // 2)) if arch.n_kv else 0
    return dataclasses.replace(
        arch, num_layers=L, d_model=H, n_heads=nh if arch.n_heads else 0,
        n_kv=nkv, head_dim=H // nh if arch.n_heads else 0,
        d_ff=2 * H if arch.d_ff else 0, vocab=min(arch.vocab, V),
        n_experts=min(arch.n_experts, 4) if arch.n_experts else 0,
        top_k=min(arch.top_k, 2) if arch.top_k else 0,
        d_ff_expert=H if arch.n_experts else 0,
        d_inner=2 * H if arch.block in ("ssm", "hymba") else 0,
        ssm_state=min(arch.ssm_state, 16) if arch.ssm_state else 0,
        ssm_headdim=32 if arch.block in ("ssm", "hymba") else 64,
        window=min(arch.window, 64) if arch.window else 0)
