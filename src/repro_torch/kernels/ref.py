"""Plain PyTorch versions of the port's kernels (ported from
``repro.kernels.ref``). The wrappers take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Layouts
match the kernel entry points: head-major attention, [T,H] rmsnorm,
head-major SSD scan.

The two backwards (``flash_attention_bwd_ref``, ``rmsnorm_bwd_ref``) are
written out, not taken from autograd: they are the math of the CUDA
backward kernels, and ``tests/test_torch_grad.py`` holds them against
autograd of the forwards here and ``jax.vjp`` of ``repro.kernels.ref``.
Everything computes in fp32, or in fp64 for fp64 inputs (gradcheck)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "rmsnorm_ref", "rmsnorm_bwd_ref",
           "ssd_scan_ref"]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def attention_mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S,S] boolean, True where query row i attends to key column j."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd]. Naive softmax in fp32."""
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    acc = _acc(q.dtype)
    qg = q.reshape(B, nkv, nh // nkv, S, hd).to(acc)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(acc)) * hd ** -0.5
    mask = attention_mask(S, causal, window, q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # fully-masked rows -> 0
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.to(acc))
    return out.reshape(B, nh, S, hd).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal=True, window=0):
    """The backward of ``flash_attention_ref``: (q, k, v, its output o, the
    gradient do of o) -> (dq, dk, dv) in the types of q, k, v. FA2's math:
    P recomputed from q, k and the row log-sum-exp, D = rowsum(do o),
    dV = P^T dO, dS = P (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale,
    dK and dV summed over the nh / nkv query heads of each kv head."""
    return flash_bwd_masked(q, k, v, o, do, attention_mask(q.shape[2], causal, window, q.device))


def flash_bwd_masked(q, k, v, o, do, mask):
    """``flash_attention_bwd_ref`` under any [S,S] boolean ``mask`` (True =
    attend). Rows with no live key give zero gradients: their log-sum-exp
    is -inf, and every entry is masked before the exp."""
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    acc = _acc(q.dtype)
    scale = hd ** -0.5
    grp = lambda t: t.reshape(B, nkv, nh // nkv, S, hd).to(acc)
    qg, og, dog = grp(q), grp(o), grp(do)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, kf) * scale
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp((s - lse).masked_fill(~mask, float("-inf")))
    d = (dog * og).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dog, vf) - d)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg) * scale
    return dq.reshape(B, nh, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    acc = _acc(x.dtype)
    xf = x.to(acc)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(acc)[None, :]).to(x.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-5):
    """The backward of ``rmsnorm_ref``: (x [T,H], w [H], dy [T,H]) -> (dx in
    x's type, dw in w's type). With r = rsqrt(mean(x^2) + eps) per row:
    dx = r (w dy) - x r^3 mean(x w dy), dw = sum over rows of dy x r."""
    acc = _acc(x.dtype)
    xf, wf, dyf = x.to(acc), w.to(acc)[None, :], dy.to(acc)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    c = (xf * wf * dyf).mean(dim=-1, keepdim=True)
    dx = r * (wf * dyf) - xf * (r * r * r) * c
    dw = (dyf * xf * r).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
