"""Plain PyTorch versions of the port's kernels (ported from
``repro.kernels.ref``). The wrappers take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Layouts
match the kernel entry points: head-major attention, [T,H] rmsnorm,
head-major SSD scan."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_attention_ref", "rmsnorm_ref", "ssd_scan_ref"]


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


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk=256, initial_state=None, return_state=False):
    """Mamba2 SSD scan, chunked (the math of ``repro.models.layers.ssd_scan``
    and of the Pallas kernel). x: [B,nh,S,hp]; dt: [B,nh,S] (softplus-ed);
    A: [nh] (negative); Bm/Cm: [B,S,N], shared across heads -> [B,nh,S,hp]
    in x's dtype, and with ``return_state`` also the final state
    [B,nh,hp,N] fp32. The recurrence starts from ``initial_state``
    ([B,nh,hp,N]) or zeros. fp32 inside; the tail is padded with dt = 0,
    which makes the padded tokens no-ops (they leave the state as it is).
    Vectorised over chunks; only the inter-chunk recurrence loops, once per
    chunk."""
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, pad)).reshape(B, nh, nc, Q, hp)
    dtc = F.pad(dt.to(f32), (0, pad)).reshape(B, nh, nc, Q)
    Bc = F.pad(Bm.to(f32), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.to(f32), (0, 0, 0, pad)).reshape(B, nc, Q, N)

    acs = torch.cumsum(dtc * A.to(f32)[None, :, None, None], dim=-1)    # [B,nh,nc,Q]
    # 1) intra-chunk, attention form: C_i.B_j exp(acs_i - acs_j) dt_j for
    # j <= i, masked before exp (acs_i - acs_j > 0 above the diagonal)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                        # [B,nc,Q,Q]
    scores = cb[:, None] * decay * dtc[..., None, :]                    # [B,nh,nc,Q,Q]
    y = torch.einsum("bhcij,bhcjp->bhcip", scores, xc)
    del decay, scores
    # 2) chunk states: sum_j exp(acs_last - acs_j) dt_j x_j B_j^T
    w = torch.exp(acs[..., -1:] - acs) * dtc
    states = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], Bc)   # [B,nh,nc,hp,N]
    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(acs[..., -1])                               # [B,nh,nc]
    h = (torch.zeros(B, nh, hp, N, dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    h_prev = torch.stack(entering, dim=2)                               # [B,nh,nc,hp,N]
    # 4) inter-chunk output: (C_i . h_prev) exp(acs_i)
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cc, h_prev) * torch.exp(acs)[..., None]
    y = y.reshape(B, nh, nc * Q, hp)[:, :, :S].to(x.dtype)
    return (y, h) if return_state else y


def rmsnorm_ref(x, w, eps=1e-5):
    """x: [T,H]; w: [H]. Multiplies by w in fp32, then casts (as the kernel)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()[None, :]).to(x.dtype)
