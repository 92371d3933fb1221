"""The plain SSD scan, frozen here: Mamba-2's minimal chunked form
(arXiv:2405.21060, listing 1, ``ssd_minimal_discrete``) with the
discretisation written out, in fp32.

y[t] = sum_{s<=t} C[t]^T (prod_{s<r<=t} exp(dt[r] A)) B[s] dt[s] x[s]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: sum of x over (s, t] below the diagonal,
    -inf above it."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~below, 0)
    seg = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        chunk: int = 64) -> torch.Tensor:
    """x [b, S, h, p], dt [b, S, h] (after softplus), A [h] (negative), B and
    C [b, S, n] shared by the heads -> y [b, S, h, p]. S is padded to a
    whole number of chunks with zeros, which changes no earlier output."""
    b, S, h, p = x.shape
    pad = -S % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = x.shape[1] // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)            # b h c l
    Bc, Cc = Bm.reshape(b, c, chunk, -1), Cm.reshape(b, c, chunk, -1)
    A_cum = torch.cumsum(Ad, dim=-1)
    L = torch.exp(_segsum(Ad))                                           # b h c l s
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, L, X)
    decay = torch.exp(A_cum[..., -1:] - A_cum)                           # b h c l
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))      # b h c+1 c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(A_cum))
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :S]
