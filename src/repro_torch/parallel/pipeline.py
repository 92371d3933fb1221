"""Pipeline parallelism on a mesh axis, the counterpart of
``repro.parallel.pipeline``: the GPipe schedule.

S stages on the axis, G microbatches, T = G + S - 1 ticks. Each tick every
stage applies its layer block to the activation it holds, then the
activations shift one stage along the ring (one ``batch_isend_irecv`` of
a send and a receive, so no rank blocks). Stage 0 takes microbatch
clip(t, 0, G - 1); microbatch g leaves the last stage at tick g + S - 1,
and the last stage's outputs are broadcast to every stage (an all-reduce
of the masked output). Differentiable: the shift's backward sends the
gradients along the reverse ring, and the broadcast's backward is the
identity (every rank computes the same loss from the same outputs). The
bubble is (S - 1) / (G + S - 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from .comm import _AllReduce, local

__all__ = ["pipeline_apply", "make_pipeline_loss"]


def _shift(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send x to global rank ``to`` and receive a tensor like it from ``frm``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    """x to the next stage, the previous stage's x back; the backward runs
    the reverse ring."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _shift(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   microbatches: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    """Run the GPipe pipeline over the mesh axis ``axis``; returns the
    outputs [G, B, ...] on every rank. ``stage_params``: a tree (nested
    dicts) of this rank's stage, each leaf with a leading stage dim of 1:
    the reference's leaves [S, ...] sharded over ``axis`` (DTensors
    ``Shard(0)`` there, or their local blocks). ``microbatches`` [G, B, ...]:
    the same on every rank (stage 0 consumes them)."""
    group = mesh.get_group(axis)
    S, s = dist.get_world_size(group), mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (s + 1) % S)
    prv = dist.get_global_rank(group, (s - 1) % S)
    G = microbatches.shape[0]
    T = G + S - 1
    params = tree_map(lambda p: local(p)[0], stage_params)
    first = torch.tensor(s == 0, device=microbatches.device)
    last = torch.tensor(s == S - 1, device=microbatches.device)
    buf = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(T):
        inp = torch.where(first, microbatches[min(t, G - 1)], buf)
        out = stage_fn(params, inp)
        if t + 1 < T:
            buf = _RingShift.apply(out, group, nxt, prv)
        ys.append(_AllReduce.apply(torch.where(last, out, torch.zeros_like(out)), group))
    return torch.stack(ys[S - 1:])


def make_pipeline_loss(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                       loss_head: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                       mesh, axis: str = "pod"):
    """Pipelined loss: the mean over microbatches of loss_head(output,
    labels), differentiable end to end."""

    def loss_fn(stage_params, microbatches, labels):
        outs = pipeline_apply(stage_fn, stage_params, microbatches, mesh, axis)
        return torch.stack([loss_head(o, y) for o, y in zip(outs, labels)]).mean()

    return loss_fn
