"""Plain PyTorch versions of the port's kernels (ported from
``repro.kernels.ref``). The wrappers take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Layouts
match the kernel entry points: head-major attention, [T,H] rmsnorm."""

from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "rmsnorm_ref"]


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd]. Naive softmax in fp32."""
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, S, hd).float()
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # fully-masked rows -> 0
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(B, nh, S, hd).to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-5):
    """x: [T,H]; w: [H]. Multiplies by w in fp32, then casts (as the kernel)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()[None, :]).to(x.dtype)
