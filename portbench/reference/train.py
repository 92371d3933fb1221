"""Training steps in fp32: the loss over G microbatches, its gradients
and Adam, from the weights drawn again from the seed.

Adam as the traffic file states it (``optimizer``): linear warm-up then
cosine decay of the learning rate, the global gradient norm clipped,
bias-corrected moments, decoupled weight decay on every leaf but those
named under ``no_decay``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from .. import weights
from ..sizes import Sizes
from .common import LowP, fp32_only
from .lm import fwd_bwd


def lr_at(opt: Dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(1, opt["warmup_steps"])
    prog = min(max((step - opt["warmup_steps"]) / max(1, opt["decay_steps"] - opt["warmup_steps"]),
                   0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adam(opt: Dict, step: int, P, grads, m, v) -> float:
    """One update of ``P``, ``m``, ``v`` in place; returns the clip scale."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9)) if opt["grad_clip"] > 0 else 1.0
    b1, b2, lr = opt["b1"], opt["b2"], lr_at(opt, step)
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for n, p in P.items():
        g = grads[n] * scale
        m[n].mul_(b1).add_((1 - b1) * g)
        v[n].mul_(b2).add_((1 - b2) * g * g)
        upd = (m[n] / c1) / (torch.sqrt(v[n] / c2) + opt["eps"])
        if n not in opt["no_decay"]:
            upd += opt["weight_decay"] * p
        p -= lr * upd
    return scale


def steps(sz: Sizes, bsizes: Dict, opt: Dict, seed: int, batch_at: Callable[[int], Dict],
          n_steps: int, device, copy_dtype: torch.dtype, lowp: Optional[LowP] = None) -> Dict:
    """Follow the first ``n_steps`` steps (``batch_at(t)``: step t's batch,
    [G, B, S] leaves, t from 1). Returns {"loss": [per step], "grad":
    {leaf: norm of the first step's gradient as Adam takes it (after the
    clip)}, "v": {leaf: norm of the second moment after the steps},
    "change": {leaf: norm of the change of the weights after the steps},
    "copy", "copy0", "moved": {leaf: at ``weights.copy_sample``'s indices,
    the weights after the steps and before them rounded to
    ``copy_dtype``, and the fp32 weights' change}}."""
    fp32_only()
    P = weights.masters(sz, seed, device)
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    grads = {n: torch.zeros_like(p) for n, p in P.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for t in range(1, n_steps + 1):
        batch = batch_at(t)
        G, B = batch["tokens"].shape[:2]
        for g in grads.values():
            g.zero_()
        loss = 0.0
        for i in range(G):
            for r in range(B):
                loss += fwd_bwd(P, sz, bsizes, batch["tokens"][i, r], batch["labels"][i, r], grads,
                                lowp) / (G * B)
        with torch.no_grad():
            for g in grads.values():
                g.div_(G * B)
        losses.append(loss)
        scale = adam(opt, t, P, grads, m, v)
        if t == 1:
            first = {n: float(torch.linalg.vector_norm(g)) * scale for n, g in grads.items()}
    second = {n: float(torch.linalg.vector_norm(t)) for n, t in v.items()}
    del grads, m, v
    change, copy, copy0, moved = {}, {}, {}, {}
    with torch.no_grad():
        for _, index, _ in weights.parts(sz):
            for n, p0 in weights.draw(sz, seed, index, device).items():
                change[n] = float(torch.linalg.vector_norm(P[n] - p0))
                at = weights.copy_sample(seed, n, p0.numel(), device)
                w, w0 = P[n].reshape(-1)[at], p0.reshape(-1)[at]
                copy[n] = w.to(copy_dtype).float().cpu()
                copy0[n] = w0.to(copy_dtype).float().cpu()
                moved[n] = (w - w0).abs().cpu()
    return {"loss": losses, "grad": first, "v": second, "change": change, "copy": copy,
            "copy0": copy0, "moved": moved}
