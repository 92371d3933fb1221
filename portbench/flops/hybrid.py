"""The launches one prefill of a configuration of mixed layer kinds with
expert layers makes (``portbench.hybrid``: granite-4.0-h-small), from the
configuration and the MoE counters.

A forward of rows [B, S] runs, per layer: RMSNorm; the Mamba-2 mixer
(in_proj, the SSD scan, the gated RMSNorm, out_proj) or the attention
mixer (q, k, v and o around the flash kernel); RMSNorm; the MoE: the
router's product, the routed experts' three grouped products and the
shared expert's three; then the final RMSNorm and the tied head over the
last position. Port kernels: RMSNorm 3 a Mamba layer, 2 an attention
layer and 1 more; the SSD scan once a Mamba layer; flash once an
attention layer.

A grouped product over R rows in h experts that got rows is one launch;
its least time is the larger of its operations, 2 R k n, and its bytes,
(R k + h k n + R n) 2 (every row read and written once, each held
expert's weight once), over the peaks. It is entered here as h equal
products of R / h rows, whose summed least time is exactly that. R is
T top_k; h comes from the port's counter ``host.moe.experts_hit`` (the
mean over a request's layers).
"""

from __future__ import annotations

from typing import List

from .model import Work
from .peaks import FP32_FLOPS, bound_s


def moe(sz, T: int, hits: float) -> List:
    """The MoE products of one layer over T rows, as ``Work.gemm`` entries:
    the router's, the routed experts' (``hits`` experts got rows) and the
    shared expert's."""
    H, Fe, Fs, R = sz.d_model, sz.d_ff_expert, sz.d_ff_shared, T * sz.top_k
    h = max(1, round(hits)) if hits else 0
    gemm = [(T, H, sz.n_experts)]
    if h:
        m = R / h
        gemm += [(m, H, Fe)] * (2 * h) + [(m, Fe, H)] * h
    gemm += [(T, H, Fs)] * 2 + [(T, Fs, H)]
    return gemm


def forward(sz, B: int, S: int, last_only: bool, hits: float) -> Work:
    """The launches of one forward of rows [B, S]; ``hits``: experts that
    got rows in a layer call, on average."""
    T, H = B * S, sz.d_model
    w = Work()
    for kind in sz.layer_types:
        w.rmsnorm.append((T, H))
        if kind == "mamba":
            di, N, nh = sz.d_inner, sz.ssm_state, sz.ssm_n_heads
            w.gemm.append((T, H, 2 * di + 2 * N + nh))
            w.ssd_scan.append((B, nh, S, sz.ssm_headdim, N))
            w.rmsnorm.append((T, di))
            w.gemm.append((T, di, H))
        else:
            q, kv = sz.n_heads * sz.head_dim, sz.n_kv * sz.head_dim
            w.gemm += [(T, H, q), (T, H, kv), (T, H, kv)]
            w.flash_attention.append((B, sz.n_heads, sz.n_kv, S, sz.head_dim, True, 0))
            w.gemm.append((T, q, H))
        w.rmsnorm.append((T, H))
        w.gemm += moe(sz, T, hits)
    rows = B if last_only else T
    w.rmsnorm.append((rows, H))
    w.gemm.append((rows, H, sz.vocab))
    return w


def moe_bound(sz, T: int, hits: float) -> float:
    """Least seconds of one layer's MoE products: the router's an fp32
    product (inputs, weights and logits of 4 bytes, fp32 peak: the port
    routes in fp32), the rest bf16 at the bf16 peak."""
    (m, k, n), *rest = moe(sz, T, hits)
    total = bound_s(2 * m * k * n, (m * k + k * n + m * n) * 4, FP32_FLOPS)
    return total + sum(bound_s(2 * m * k * n, (m * k + k * n + m * n) * 2) for m, k, n in rest)
