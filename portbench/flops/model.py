"""The launches a forward or a train step of the port makes, with their
shapes, worked out from the configuration alone.

A forward of rows [B, S] through ``repro_torch.models.lm.LM`` runs, per
block: RMSNorm, then attention (q, k, v and o projections around the
flash kernel) or the Mamba-2 mixer (in_proj, the SSD scan, the gated
RMSNorm, out_proj), then for blocks with an MLP a second RMSNorm and its
two or three projections; then the final RMSNorm and the head, over the
last position only where the prefill asks for it. A train step runs G
such forwards and, for each, the backward: two GEMMs (the input's and the
weight's gradient) for each GEMM, and the backward kernel of each RMSNorm,
SSD scan and flash launch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from . import kernels
from .peaks import bound_s


@dataclass
class Work:
    """Launches by kind; each entry one launch's shape."""

    gemm: List[Tuple[int, int, int]] = field(default_factory=list)          # (m, k, n)
    rmsnorm: List[Tuple[int, int]] = field(default_factory=list)            # (T, H)
    rmsnorm_bwd: List[Tuple[int, int]] = field(default_factory=list)
    ssd_scan: List[Tuple[int, int, int, int, int]] = field(default_factory=list)  # B nh S hp N
    ssd_scan_bwd: List[Tuple[int, int, int, int, int]] = field(default_factory=list)
    flash_attention: List[Tuple] = field(default_factory=list)   # B nh nkv S hd causal window
    flash_attention_bwd: List[Tuple] = field(default_factory=list)

    def extend(self, other: "Work") -> "Work":
        for name in self.__dataclass_fields__:
            getattr(self, name).extend(getattr(other, name))
        return self

    def launches(self) -> dict:
        """Launches of each of the port's kernels (``kernels.launch_counts``' names)."""
        return {name: len(getattr(self, name)) for name in
                ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd", "flash_attention",
                 "flash_attention_bwd")}


COST = {"gemm": kernels.gemm, "rmsnorm": kernels.rmsnorm_fwd, "rmsnorm_bwd": kernels.rmsnorm_bwd,
        "ssd_scan": kernels.ssd_fwd, "ssd_scan_bwd": kernels.ssd_bwd,
        "flash_attention": kernels.flash_fwd, "flash_attention_bwd": kernels.flash_bwd}


def flops(work: Work, kinds) -> float:
    """Operations of the launches of ``kinds``."""
    return float(sum(COST[k](*shape)[0] for k in kinds for shape in getattr(work, k)))


def bound(work: Work, kinds) -> float:
    """Summed least time, in seconds, of the launches of ``kinds``."""
    return sum(bound_s(*COST[k](*shape)) for k in kinds for shape in getattr(work, k))


# the model's operations: products of matrices, the scan and attention
MODEL_KINDS = ("gemm", "ssd_scan", "ssd_scan_bwd", "flash_attention", "flash_attention_bwd")


def forward(arch, B: int, S: int, last_only: bool) -> Work:
    """The launches of one forward of rows [B, S]."""
    if arch.n_experts:
        raise NotImplementedError("the launch count of expert layers is not written yet")
    T, H = B * S, arch.d_model
    w = Work()
    for _ in range(arch.num_layers):
        w.rmsnorm.append((T, H))
        if arch.has_attention:
            q, kv = arch.n_heads * arch.head_dim, arch.n_kv * arch.head_dim
            w.gemm += [(T, H, q), (T, H, kv), (T, H, kv)]
            w.flash_attention.append((B, arch.n_heads, arch.n_kv, S, arch.head_dim, arch.causal,
                                      arch.window))
            w.gemm.append((T, q, H))
        if arch.block in ("ssm", "hymba"):
            di, N, nh = arch.d_inner, arch.ssm_state, arch.ssm_n_heads
            w.gemm.append((T, H, 2 * di + 2 * N + nh))
            w.ssd_scan.append((B, nh, S, arch.ssm_headdim, N))
            w.rmsnorm.append((T, di))
            w.gemm.append((T, di, H))
        if arch.has_attention and arch.d_ff:
            w.rmsnorm.append((T, H))
            F = arch.d_ff
            w.gemm += [(T, H, F)] * (2 if arch.mlp == "gated_silu" else 1) + [(T, F, H)]
    rows = B if last_only else T
    w.rmsnorm.append((rows, H))
    w.gemm.append((rows, H, arch.vocab))
    return w


def backward_of(fwd: Work) -> Work:
    """The backward launches of a forward: the input's and the weight's
    gradient of each GEMM, and each kernel's backward."""
    w = Work()
    for m, k, n in fwd.gemm:
        w.gemm += [(m, n, k), (k, m, n)]
    w.rmsnorm_bwd = list(fwd.rmsnorm)
    w.ssd_scan_bwd = list(fwd.ssd_scan)
    w.flash_attention_bwd = list(fwd.flash_attention)
    return w


def train_step(arch, microbatches: int, B: int, S: int) -> Work:
    """The launches of one train step: G forwards and backwards of [B, S]."""
    w = Work()
    for _ in range(microbatches):
        fwd = forward(arch, B, S, last_only=False)
        w.extend(fwd).extend(backward_of(fwd))
    return w
