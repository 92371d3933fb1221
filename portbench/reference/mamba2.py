"""The Mamba-2 block (arXiv:2405.21060; state-spaces/mamba ``Mamba2``
with ngroups 1), pre-norm, in fp32:

    h = RMSNorm(x) w_norm1
    z | xBC | dt = h @ in_proj               (d_inner, d_inner + 2N, heads)
    xBC = SiLU(causal depthwise conv_K(xBC) + conv_b)
    x' | B | C = xBC
    y = SSD(x', softplus(dt + dt_bias), -exp(A_log), B, C) + D x'
    out = x + RMSNorm(y SiLU(z)) w_ssm_norm @ out_proj

Departures of the configuration as run from the published model (each in
the configuration file's ``reduced``): the residual stream is not kept in
fp32 (the port adds in bf16; here everything is fp32) and the head is not
tied to the embedding.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import LowP, mm, op, rmsnorm, silu, softplus
from .ssd import ssd


def block(x: torch.Tensor, p: Dict[str, torch.Tensor], sizes: Dict,
          lowp: Optional[LowP] = None) -> torch.Tensor:
    """x [S, H] (one row) -> [S, H]; ``p`` the block's leaves by the names of
    ``portbench.weights.layer_leaves``; ``sizes``: d_inner, d_state,
    headdim, d_conv."""
    di, N, hp, K = sizes["d_inner"], sizes["d_state"], sizes["headdim"], sizes["d_conv"]
    nh = di // hp
    x = x[None]
    b, S, _ = x.shape
    h = rmsnorm(x, p["norm1"])
    z, xbc, dt = mm(h, p["ssm.in_proj"], lowp).split([di, di + 2 * N, nh], dim=-1)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, k:k + S] * p["ssm.conv_w"][k] for k in range(K)) + p["ssm.conv_b"]
    xs, Bm, Cm = silu(conv).split([di, N, N], dim=-1)
    dt = softplus(dt + p["ssm.dt_bias"])
    A = -torch.exp(p["ssm.A_log"])
    x4 = xs.reshape(b, S, nh, hp)
    if lowp is not None:
        x4, Bm, Cm = lowp.round(x4), lowp.round(Bm), lowp.round(Cm)
    y = op(ssd(x4, dt, A, Bm, Cm), lowp) + p["ssm.D"][:, None] * x4
    g = rmsnorm(y.reshape(b, S, di) * silu(z), p["ssm.ssm_norm"])
    return op(x + mm(g, p["ssm.out_proj"], lowp), lowp)[0]
