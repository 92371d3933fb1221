"""Each kernel's operations and bytes, from its shapes: copies of
``chip_smoke.py``'s ``flash_fwd_bound``, ``flash_bwd_bound``,
``ssd_fwd_bound``, ``ssd_bwd_bound`` and the RMSNorm rows' bounds, with the
counts of ``repro_torch.kernels.flash_attention.flops``/``bwd_flops`` and
``repro_torch.kernels.ssd_scan.fwd_flops``/``bwd_flops`` written out here.

Every function returns ``(flops, bytes, flops_peak)``; ``peaks.bound_s``
turns that into the least time. ``elem`` is the bytes of one activation
element (2 for bf16).
"""

from __future__ import annotations

from .peaks import BF16_FLOPS, FP32_FLOPS

SSD_CHUNK = 64          # tokens a chunk in the SSD kernels


def attention_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs the attention of S tokens computes."""
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_fwd(B, nh, nkv, S, hd, causal=True, window=0, elem=2):
    """q, k, v read once, o written once; q k^T and p v over every pair."""
    flops = 4 * B * nh * hd * attention_pairs(S, causal, window)
    nbytes = (2 * B * nh * S * hd + 2 * B * nkv * S * hd) * elem
    return flops, nbytes, BF16_FLOPS


def flash_bwd(B, nh, nkv, S, hd, causal=True, window=0, elem=2):
    """q, k, v, o, dO read, dq, dk, dv written; five products over the
    pairs (S, dP, dV, dK, dQ); the recomputed S and dP of dQ not counted."""
    flops = 5 * 2 * B * nh * hd * attention_pairs(S, causal, window)
    nbytes = (4 * B * nh * S * hd + 4 * B * nkv * S * hd) * elem
    return flops, nbytes, BF16_FLOPS


def _ssd_pairs(S: int) -> int:
    full, tail = divmod(S, SSD_CHUNK)
    return full * SSD_CHUNK * (SSD_CHUNK + 1) // 2 + tail * (tail + 1) // 2


def ssd_fwd(B, nh, S, hp, N, elem=2):
    """x read and y written (x's type), dt [B,nh,S] and A [nh] in fp32, B
    and C [B,S,N] read once; the chunked products at the kernels' chunk:
    C.B^T once a chunk, per head the scores x, the chunk state and the
    inter-chunk output."""
    Q = SSD_CHUNK
    flops = B * S * (2 * Q * N + nh * (2 * Q * hp + 4 * hp * N))
    nbytes = 2 * B * nh * S * hp * elem + B * nh * S * 4 + nh * 4 + 2 * B * S * N * elem
    return flops, nbytes, BF16_FLOPS


def ssd_bwd(B, nh, S, hp, N, elem=2):
    """x, dy, dt, A, B, C read and dx, ddt, dA, dB, dC written once; the
    products of the kernels' 64-token chunks (C.B^T a chunk, per head
    dy.x^T and the dx, dB, dC products over the causal pairs, and per token
    the five [hp, N] products)."""
    pairs = _ssd_pairs(S)
    flops = B * pairs * 2 * N + B * nh * (pairs * 2 * (2 * hp + 2 * N) + S * 5 * 2 * hp * N)
    x = B * nh * S * hp
    nbytes = 3 * x * elem + 2 * (B * nh * S + nh) * 4 + 4 * B * S * N * elem
    return flops, nbytes, BF16_FLOPS


def rmsnorm_fwd(T, H, elem=2):
    """x read, y written, w read; four fp32 operations an element."""
    return 4 * T * H, (2 * T * H + H) * elem, FP32_FLOPS


def rmsnorm_bwd(T, H, elem=2):
    """x, dy read, dx written, w read; ten fp32 operations an element."""
    return 10 * T * H, (3 * T * H + H) * elem, FP32_FLOPS


def gemm(m, k, n, elem=2):
    """[m,k] @ [k,n]: 2 m k n operations; both operands read and the
    product written once."""
    return 2 * m * k * n, (m * k + k * n + m * n) * elem, BF16_FLOPS
