"""ArchConfig -> PALM workload IR (ComputationGraph).

This is the bridge that makes the paper's technique first-class for every
assigned architecture: the planner simulates the same arch configs the
JAX launchers execute. Decomposition follows the paper's rule for
transformers ("a combination of a series of linear operators"), extended
per DESIGN.md §4 for MoE / SSM / hybrid blocks.
"""

from __future__ import annotations

from typing import List, Optional

from ..configs.base import ArchConfig
from .graph import (
    Attention,
    ComputationGraph,
    Embedding,
    Linear,
    MoELayer,
    Op,
    SSMScan,
    TransformerLayer,
)

__all__ = ["arch_to_graph"]


def _mlp_op(name: str, arch: ArchConfig, batch: int, seq: int) -> Op:
    """Standalone MLP as a Linear op (fused gate+up+down accounting)."""
    mults = 3 if arch.mlp == "gated_silu" else 2
    return Linear(name=name, B=1, M=mults * arch.d_ff, N=batch * seq, K=arch.d_model)


def arch_to_graph(
    arch: ArchConfig,
    seq_len: int,
    batch: int,
    training: bool = True,
    decode: bool = False,
) -> ComputationGraph:
    """Build the operator graph for one iteration (train fwd+bwd handled by
    the scheduler; ``decode=True`` builds the 1-token serve step against a
    ``seq_len`` KV cache)."""
    ops: List[Op] = []
    S = 1 if decode else seq_len
    if not arch.embeds_input:
        ops.append(Embedding(name="embed", B=batch, S=S, H=arch.d_model, V=arch.vocab))

    for i in range(arch.num_layers):
        if arch.block == "attn":
            if decode:
                ops.extend(_decode_layer(arch, batch, seq_len, i))
            else:
                ops.append(TransformerLayer(
                    name=f"layer{i}", B=batch, S=S, H=arch.d_model,
                    n_heads=arch.n_heads, n_kv=arch.n_kv, d_head=arch.head_dim,
                    d_ff=arch.d_ff if not arch.n_experts else 0,
                    gated_mlp=arch.mlp == "gated_silu",
                    causal=arch.causal,
                    window=arch.window or None))
            if arch.n_experts:
                ops.append(MoELayer(
                    name=f"moe{i}", B=batch, S=S, H=arch.d_model,
                    n_experts=arch.n_experts, top_k=arch.top_k,
                    d_ff_expert=arch.d_ff_expert))
        elif arch.block == "ssm":
            ops.append(SSMScan(
                name=f"ssm{i}", B=batch, S=S, H=arch.d_model,
                d_inner=arch.d_inner, d_state=arch.ssm_state,
                n_heads=arch.ssm_n_heads, conv_width=arch.conv_width))
        elif arch.block == "hymba":
            # parallel attn + mamba heads sharing the block, then MLP.
            # Reference hymba keeps 3 global-attention layers; the workload
            # IR models them; window elsewhere (DESIGN.md §4).
            is_global = i in (0, arch.num_layers // 2, arch.num_layers - 1)
            window = None if is_global else (arch.window or None)
            if decode:
                span = seq_len if is_global else min(arch.window or seq_len, seq_len)
                ops.append(Attention(
                    name=f"attn{i}", B=batch, S_q=1, S_kv=span,
                    n_heads=arch.n_heads, n_kv=arch.n_kv, d_head=arch.head_dim))
            else:
                ops.append(TransformerLayer(
                    name=f"attn{i}", B=batch, S=S, H=arch.d_model,
                    n_heads=arch.n_heads, n_kv=arch.n_kv, d_head=arch.head_dim,
                    d_ff=0, gated_mlp=False, causal=True, window=window))
            ops.append(SSMScan(
                name=f"ssm{i}", B=batch, S=S, H=arch.d_model,
                d_inner=arch.d_inner, d_state=arch.ssm_state,
                n_heads=arch.ssm_n_heads, conv_width=arch.conv_width))
            if arch.d_ff:
                ops.append(_mlp_op(f"mlp{i}", arch, batch, S))
        else:
            raise ValueError(f"unknown block {arch.block}")

    if not arch.is_encoder_only or arch.vocab:
        ops.append(Linear(name="lm_head", B=1, M=arch.vocab, N=batch * S, K=arch.d_model))
    return ComputationGraph(ops=ops, name=arch.name)


def _decode_layer(arch: ArchConfig, batch: int, cache_len: int, i: int) -> List[Op]:
    """Decode-mode transformer layer: S=1 projections/MLP + cache attention
    against the full ``cache_len`` span (a separate Attention op so the
    span is not clipped by S=1)."""
    span = min(arch.window or cache_len, cache_len)
    proj = TransformerLayer(
        name=f"layer{i}", B=batch, S=1, H=arch.d_model,
        n_heads=arch.n_heads, n_kv=arch.n_kv, d_head=arch.head_dim,
        d_ff=arch.d_ff if not arch.n_experts else 0,
        gated_mlp=arch.mlp == "gated_silu", causal=False, window=1)
    attn = Attention(
        name=f"cache_attn{i}", B=batch, S_q=1, S_kv=span,
        n_heads=arch.n_heads, n_kv=arch.n_kv, d_head=arch.head_dim)
    return [proj, attn]
