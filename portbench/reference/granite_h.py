"""granite-4.0-h-small (IBM Granite 4.0-H Small, Hugging Face
``granitemoehybrid``) in plain fp32 PyTorch, a layer at a time:

    x = embedding_multiplier E[tokens]
    each layer, Mamba-2 or attention as ``layer_types`` says:
        x = x + r mixer(RMSNorm(x) w_norm1)
        h = RMSNorm(x) w_norm2
        l = h W_router;  the top k of l, gates = softmax over those k
        x = x + r (sum over the top k of gate_j expert_j(h) + shared(h))
    logits = RMSNorm(x) w_final E^T / logits_scaling

with r the ``residual_multiplier``, each expert and the shared expert a
gated-SiLU MLP, (SiLU(h wg) (h wi)) wo. The attention mixer is causal GQA
without rotary embedding (``position_embedding_type`` "nope"), its softmax
scale ``attention_multiplier``; the Mamba-2 mixer is ``mamba2``'s
(in_proj, the causal depthwise conv with bias, SiLU, the SSD of
``ssd.ssd``, the D skip, RMSNorm(y SiLU(z)) over all of d_inner, one group,
out_proj). Every expert runs every row routed to it (dropless).

Departures from the Hugging Face code, none of which changes the
mathematics: everything is fp32 (TF32 off), where the published model
computes in bf16 and takes its router logits from a bf16 product; the SSD
is the minimal chunked form at 64 tokens a chunk, where the published
kernels chunk by ``mamba_chunk_size`` 256 (the same sums in another
order); the attention's scale is applied to q before ``dense.attention``
applies hd^-0.5 (q times scale sqrt(hd)); a prompt is one row with no
padding or attention mask.

Weights are drawn again from the seed a layer at a time
(``portbench.hybrid``) and rounded to the type the run serves them in;
the MoE of a layer runs over the rows of every prompt at once, the
mixers a prompt at a time. Every function takes ``lowp`` as
``common.LowP`` defines it (the fp8 control). ``compute`` (fp32 unless a
test asks for the reference's own bf16) is the type the weights and the
activations are held in.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import hybrid
from .common import LowP, fp32_only, mm, op, rmsnorm, silu, softplus
from .dense import attention
from .ssd import ssd


def _part(sz, seed: int, index: int, device, served,
          compute=torch.float32) -> Dict[str, torch.Tensor]:
    """Part ``index``'s leaves in ``compute`` by their names within the
    part, each rounded through ``served`` (a dtype, or None for fp32
    weights)."""
    out = {}
    for name, t in hybrid.draw(sz, seed, index, device).items():
        short = name.split(".", 2)[2] if name.startswith("blocks.") else name
        out[short] = (t if served is None else t.to(served)).to(compute)
    return out


def attention_mixer(h: torch.Tensor, p: Dict[str, torch.Tensor], sz,
                    lowp: Optional[LowP] = None) -> torch.Tensor:
    """h [S, H] (normed) -> [S, H]: NoPE causal GQA at ``attn_scale``."""
    S = h.shape[0]
    nh, nkv, hd = sz.n_heads, sz.n_kv, sz.head_dim
    q = mm(h, p["attn.wq"], lowp).reshape(S, nh, hd) * (sz.attn_scale * hd ** 0.5)
    k = mm(h, p["attn.wk"], lowp).reshape(S, nkv, hd)
    v = mm(h, p["attn.wv"], lowp).reshape(S, nkv, hd)
    return mm(attention(q, k, v, lowp).reshape(S, nh * hd), p["attn.wo"], lowp)


def mamba_mixer(h: torch.Tensor, p: Dict[str, torch.Tensor], sz,
                lowp: Optional[LowP] = None) -> torch.Tensor:
    """h [S, H] (normed) -> [S, H]: the Mamba-2 mixer of ``mamba2.block``."""
    di, N, hp, K = sz.d_inner, sz.ssm_state, sz.ssm_headdim, sz.conv_width
    nh = di // hp
    S = h.shape[0]
    z, xbc, dt = mm(h, p["ssm.in_proj"], lowp).split([di, di + 2 * N, nh], dim=-1)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[k:k + S] * p["ssm.conv_w"][k] for k in range(K)) + p["ssm.conv_b"]
    xs, Bm, Cm = silu(conv).split([di, N, N], dim=-1)
    dt = softplus(dt + p["ssm.dt_bias"])
    A = -torch.exp(p["ssm.A_log"])
    x4 = xs.reshape(1, S, nh, hp)
    Bm, Cm = Bm[None], Cm[None]
    if lowp is not None:
        x4, Bm, Cm = lowp.round(x4), lowp.round(Bm), lowp.round(Cm)
    y = op(ssd(x4, dt[None], A, Bm, Cm), lowp) + p["ssm.D"][:, None] * x4
    g = rmsnorm(y.reshape(S, di) * silu(z), p["ssm.ssm_norm"])
    return mm(g, p["ssm.out_proj"], lowp)


MIXERS = {"attention": attention_mixer, "mamba": mamba_mixer}


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], sz,
        lowp: Optional[LowP] = None) -> torch.Tensor:
    """h [T, H] (normed rows, any prompts) -> [T, H]: the top-k of the
    router's logits, gates the softmax over those k, every routed row
    through its expert, plus the shared expert on every row."""
    logits = mm(h, p["moe.router"], lowp)
    top, idx = torch.topk(logits, sz.top_k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for e in range(sz.n_experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        he = h[rows]
        y = mm(silu(mm(he, p["moe.wg"][e], lowp)) * mm(he, p["moe.wi"][e], lowp),
               p["moe.wo"][e], lowp)
        out.index_add_(0, rows, y * gates[rows, slot, None])
    shared = mm(silu(mm(h, p["shared.wg"], lowp)) * mm(h, p["shared.wi"], lowp),
                p["shared.wo"], lowp)
    return out + shared


def layer(xs: List[torch.Tensor], p: Dict[str, torch.Tensor], kind: str, sz,
          lowp: Optional[LowP] = None) -> List[torch.Tensor]:
    """One layer of kind ``kind`` over the prompts' rows ``xs`` ([S_i, H]
    each): the mixer a prompt at a time, the MoE over all rows at once."""
    r = sz.residual_scale
    xs = [op(x + r * MIXERS[kind](rmsnorm(x, p["norm1"]), p, sz, lowp), lowp) for x in xs]
    rows = torch.cat(xs)
    y = moe(rmsnorm(rows, p["norm2"]), p, sz, lowp)
    return [op(x + r * d, lowp) for x, d in zip(xs, y.split([x.shape[0] for x in xs]))]


def embed(sz, seed: int, prompts: List[torch.Tensor], device, served=torch.bfloat16,
          lowp: Optional[LowP] = None, compute=torch.float32) -> List[torch.Tensor]:
    """The first activations [S_i, H] of prompts of token ids [S_i]."""
    emb = _part(sz, seed, -1, device, served, compute)["embed"]
    return [op(emb[t] * sz.embed_scale, lowp) for t in prompts]


def head(sz, seed: int, xs: List[torch.Tensor], device, served=torch.bfloat16,
         lowp: Optional[LowP] = None, compute=torch.float32) -> List[torch.Tensor]:
    """The fp32 logits [V] at the last position of each of ``xs``: the
    final norm, the tied head, the logit scaling."""
    final = _part(sz, seed, sz.num_layers, device, served, compute)["final_norm"]
    emb = _part(sz, seed, -1, device, served, compute)["embed"]
    return [mm(rmsnorm(x[-1:], final), emb.t(), lowp)[0].float() / sz.logit_scale for x in xs]


@torch.no_grad()
def last_logits(sz, seed: int, prompts: List[torch.Tensor], device, served=torch.bfloat16,
                lowp: Optional[LowP] = None, compute=torch.float32) -> List[torch.Tensor]:
    """The fp32 logits [V] at the last position of each prompt (token ids
    [S]), all prompts carried through one layer before the next is drawn."""
    fp32_only()
    xs = embed(sz, seed, prompts, device, served, lowp, compute)
    for i, kind in enumerate(sz.layer_types):
        xs = layer(xs, _part(sz, seed, i, device, served, compute), kind, sz, lowp)
    return head(sz, seed, xs, device, served, lowp, compute)
