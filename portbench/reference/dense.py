"""The dense block of a Llama-architecture model (Yi, arXiv:2403.04652):
pre-norm grouped-query attention with rotary embeddings, then a
gated-SiLU MLP, in fp32:

    h = RMSNorm(x) w_norm1
    q, k, v = h wq, h wk, h wv;  q, k = rope(q), rope(k)
    x = x + softmax(q k^T / sqrt(hd), causal) v  wo      (kv head j serves
                                                          q heads j g .. j g + g - 1)
    h = RMSNorm(x) w_norm2
    x = x + (SiLU(h wg) (h wi)) wo

Attention runs a block of query rows at a time, so an 8k prompt's
[heads, S, S] scores never exist whole.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import LowP, mm, op, rmsnorm, rope, silu

Q_BLOCK = 1024


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lowp: Optional[LowP]) -> torch.Tensor:
    """Causal attention of q [S, nh, hd] over k, v [S, nkv, hd]."""
    S, nh, hd = q.shape
    g = nh // k.shape[1]
    kh = op(k, lowp).repeat_interleave(g, dim=1).transpose(0, 1)          # nh S hd
    vh = op(v, lowp).repeat_interleave(g, dim=1).transpose(0, 1)
    qh = op(q, lowp).transpose(0, 1)
    out = torch.empty_like(qh)
    for r0 in range(0, S, Q_BLOCK):
        r1 = min(S, r0 + Q_BLOCK)
        s = qh[:, r0:r1] @ kh[:, :r1].transpose(1, 2) * hd ** -0.5        # nh rows r1
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(r1, device=q.device)[None, :] > rows, float("-inf"))
        out[:, r0:r1] = op(torch.softmax(s, dim=-1), lowp) @ vh[:, :r1]
    return out.transpose(0, 1)


def block(x: torch.Tensor, p: Dict[str, torch.Tensor], sizes: Dict,
          lowp: Optional[LowP] = None) -> torch.Tensor:
    """x [S, H] (one prompt) -> [S, H]; ``sizes``: heads, kv_heads,
    head_dim, rope_theta."""
    S, H = x.shape
    nh, nkv, hd = sizes["heads"], sizes["kv_heads"], sizes["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, p["norm1"])
    q = rope(mm(h, p["attn.wq"], lowp).reshape(S, nh, hd), pos, sizes["rope_theta"])
    k = rope(mm(h, p["attn.wk"], lowp).reshape(S, nkv, hd), pos, sizes["rope_theta"])
    v = mm(h, p["attn.wv"], lowp).reshape(S, nkv, hd)
    x = op(x + mm(attention(q, k, v, lowp).reshape(S, nh * hd), p["attn.wo"], lowp), lowp)
    h = rmsnorm(x, p["norm2"])
    inner = silu(mm(h, p["mlp.wg"], lowp)) * mm(h, p["mlp.wi"], lowp)
    return op(x + mm(inner, p["mlp.wo"], lowp), lowp)
