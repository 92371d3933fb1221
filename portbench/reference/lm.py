"""The whole model around the blocks: embedding, the blocks one layer at
a time, the final RMSNorm, the head and the next-token loss.

Weights are drawn again from the seed a part at a time
(``portbench.weights``), rounded to the type the configuration serves or
trains its compute weights in where the run hands the port such weights,
and held in fp32. Activations of one row are [S, H].
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .. import weights
from ..sizes import Sizes
from . import dense, mamba2
from .common import LowP, fp32_only, mm, op, rmsnorm

BLOCKS: Dict[str, Callable] = {"attn": dense.block, "ssm": mamba2.block}


def _part(sz: Sizes, seed: int, index: int, device, served) -> Dict[str, torch.Tensor]:
    """Part ``index``'s leaves in fp32, by their names within the part,
    each rounded through ``served`` (a dtype, or None for fp32 weights)."""
    out = {}
    for name, t in weights.draw(sz, seed, index, device).items():
        short = name.split(".", 2)[2] if name.startswith("blocks.") else name
        out[short] = t if served is None else t.to(served).to(torch.float32)
    return out


@torch.no_grad()
def last_logits(sz: Sizes, bsizes: Dict, seed: int, prompts: List[torch.Tensor], device,
                served=torch.bfloat16, lowp: Optional[LowP] = None) -> List[torch.Tensor]:
    """The fp32 logits [V] at the last position of each prompt (token ids
    [S]), all prompts carried through one layer before the next is drawn."""
    fp32_only()
    emb = _part(sz, seed, -1, device, served)["embed"]
    xs = [op(emb[p], lowp) for p in prompts]
    del emb
    block = BLOCKS[sz.block]
    for i in range(sz.num_layers):
        p = _part(sz, seed, i, device, served)
        xs = [block(x, p, bsizes, lowp) for x in xs]
    head = _part(sz, seed, sz.num_layers, device, served)
    return [mm(rmsnorm(x[-1:], head["final_norm"]), head["lm_head"], lowp)[0] for x in xs]


def fwd_bwd(P: Dict[str, torch.Tensor], sz: Sizes, bsizes: Dict, tokens: torch.Tensor,
            labels: torch.Tensor, grads: Dict[str, torch.Tensor],
            lowp: Optional[LowP] = None) -> float:
    """The mean next-token loss of one row (tokens, labels [S]) under the
    fp32 weights ``P`` (full names), its gradients added into ``grads``.
    The forward keeps each layer's input only; the backward runs the
    layers again one at a time under autograd."""
    block = BLOCKS[sz.block]
    layer = lambda i: {n.split(".", 2)[2]: t for n, t in P.items() if n.startswith(f"blocks.{i}.")}
    with torch.no_grad():
        xs = [op(P["embed"][tokens], lowp)]
        for i in range(sz.num_layers):
            xs.append(block(xs[-1], layer(i), bsizes, lowp))
    x = xs.pop().requires_grad_(True)
    fn = P["final_norm"].detach().requires_grad_(True)
    head = P["lm_head"].detach().requires_grad_(True)
    logits = mm(rmsnorm(x, fn), head, lowp)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None].long())[:, 0]
    loss = nll.mean()
    loss.backward()
    grads["final_norm"] += fn.grad
    grads["lm_head"] += head.grad
    dx = x.grad
    del logits, nll, x
    for i in reversed(range(sz.num_layers)):
        xin = xs.pop().requires_grad_(True)
        p = {n: t.detach().requires_grad_(True) for n, t in layer(i).items()}
        block(xin, p, bsizes, lowp).backward(dx)
        for n, t in p.items():
            grads[f"blocks.{i}.{n}"] += t.grad
        dx = xin.grad
    grads["embed"].index_add_(0, tokens.long(), dx)
    return float(loss.detach())
