"""What a model on a ``DeviceMesh`` communicates: the collectives that
``repro_torch.models.lm`` runs where the reference leaves them to GSPMD
(its ``with_sharding_constraint`` hints, ``repro/models/lm.py:56-69``).

Weights are DTensors at the planner's placements. ``MeshComm.weight``
gathers one for its layer and hands the kernels a plain local tensor;
its backward takes the local gradient back onto the weight's placements
as a DTensor: partial over the batch axes, so a gather over ``data``
turns into a reduce-scatter (FSDP, ZeRO-2) and a replicated dim into an
all-reduce.

Activations are plain local tensors, moved by the autograd Functions below
over the ``model`` axis's process group (Megatron's pattern: an identity
whose backward all-reduces before a column-parallel product, an all-reduce
after a row-parallel one; with ``seq_shard``, an all-gather of the
sequence whose backward reduce-scatters, and a reduce-scatter back onto
the sequence shards; ``psum``, a sum every rank reads whole, whose
backward sums too). They use only ``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which NCCL and
gloo both run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

__all__ = ["MeshComm", "is_dtensor", "local", "all_reduce_over", "gather_dim", "psum"]

_MODEL = "model"


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (the same storage), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


def _check_mesh(mesh) -> None:
    names = mesh.mesh_dim_names or ()
    if "data" not in names or _MODEL not in names:
        raise ValueError(f"a model's mesh needs axes 'data' and 'model', got {names}")


def all_reduce_over(t: torch.Tensor, mesh, dims: Sequence[int],
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the mesh dims ``dims``, one collective
    a dim (the product of the dims' groups)."""
    for d in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(d))
    return t


# Both move whole blocks: the ranks' shards are stacked on a leading dim
# [n, ...] and merged into ``dim`` (or split from it) by one copy whose
# contiguous runs are a shard's rows, never an element-wise transpose; with
# one rank the copy is a view.

def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    shape = list(x.shape)
    shape[dim:dim + 1] = [n, shape[dim] // n]
    parts = x.contiguous().view(shape).movedim(dim, 0).contiguous()
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.view(-1, *parts.shape[2:]), group=group)
    return out


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather of ``x`` along ``dim`` (no autograd)."""
    return _gather(x, dim, group)


class _ReduceInBackward(torch.autograd.Function):
    """Identity; the backward all-reduces (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    """All-reduce of partial sums; the backward is the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    """All-reduce of a sum every rank reads whole; the backward all-reduces
    too (each rank's gradient is a part of each input's), where
    ``_AllReduce``'s identity backward is right only for a row-parallel
    product's output, whose gradient every rank already holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, the backward summing over it too (JAX's
    ``psum`` and its transpose)."""
    return _Psum.apply(x, group)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. The backward reduce-scatters where the
    gathered tensor feeds a computation each rank does a part of
    (``partial``), and takes this rank's chunk where every rank computes
    the same from it."""

    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        f = _reduce_scatter if ctx.partial else _chunk
        return f(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter of partial sums along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _GatherWeight(torch.autograd.Function):
    """A DTensor weight -> the plain local tensor a layer computes with:
    gathered over every mesh dim it is sharded on but those in ``keep``.
    The backward takes the local gradient back onto the weight's
    placements: over a gathered dim it reduce-scatters (``partial[i]``: the
    ranks' gradients are parts of the whole) or takes this rank's chunk;
    over a replicated dim it all-reduces where ``partial[i]``. (DTensor's
    ``redistribute`` with ``to_local(grad_placements=)`` computes the same;
    this keeps every collective a plain c10d call, as the activations'
    are, one a mesh dim even where the dim has one rank.)"""

    @staticmethod
    def forward(ctx, p, groups, keep, partial):
        ctx.spec = (p.device_mesh, tuple(p.placements), p.shape, p.stride())
        ctx.groups, ctx.keep, ctx.partial = groups, keep, partial
        x = p.to_local()
        for i in reversed(range(len(groups))):          # minor mesh dim first
            pl = p.placements[i]
            if pl.is_shard() and not keep[i]:
                x = _gather(x, pl.dim, groups[i])
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, placements, shape, stride = ctx.spec
        for i, pl in enumerate(placements):
            if pl.is_shard() and not ctx.keep[i]:
                g = (_reduce_scatter if ctx.partial[i] else _chunk)(g, pl.dim, ctx.groups[i])
            elif not pl.is_shard() and ctx.partial[i]:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=ctx.groups[i])
        g = DTensor.from_local(g.contiguous(), mesh, placements, run_check=False, shape=shape,
                               stride=stride)
        return g, None, None, None


class MeshComm:
    """One model's collectives on ``mesh`` (axes "data" and "model", and
    "pod" on multi-pod meshes); the batch is sharded over ``batch_axes``,
    ("pod", "data") or ("data",) (the reference's ``_with_mesh_cfg``,
    ``repro/train/step.py:38-43``). ``seq_shard``: the residual stream between blocks is sharded over
    "model" on the sequence dim (dim 1 of [B, S, H])."""

    def __init__(self, mesh, seq_shard: bool = False):
        _check_mesh(mesh)
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.model_dim = self.names.index(_MODEL)
        self.data_dim = self.names.index("data")
        self.batch_axes = ("pod", "data") if "pod" in self.names else ("data",)
        self.batch_dims = tuple(self.names.index(a) for a in self.batch_axes)
        self.size = mesh.size(self.model_dim)
        self.groups = tuple(mesh.get_group(i) for i in range(len(self.names)))
        self.group = self.groups[self.model_dim]
        self.rank = mesh.get_local_rank(self.model_dim)
        self.seq_shard = seq_shard

    def seq_sharded(self, S: int) -> bool:
        """Whether a sequence of S positions is sharded between blocks: with
        ``seq_shard``, where S divides the axis (the reference's ``fit_first``
        drops the axis elsewhere)."""
        return self.seq_shard and S % self.size == 0

    # ---------------------------------------------------------------- weights

    def weight(self, p, tp_dim: Optional[int] = None, partial: bool = False) -> torch.Tensor:
        """The local tensor of weight ``p`` (a DTensor) that a layer computes
        with: gathered over every batch axis (FSDP), kept sharded over
        "model" on ``tp_dim`` (tensor parallel; ``p`` must be sharded
        there) or gathered over it too. Its gradient is partial over the
        batch axes (each rank sees its rows), exact on a kept model shard,
        and over a gathered model axis partial where ``partial`` (each model
        rank uses a part of the weight, or sees a part of the rows), else
        the same on every rank (a mesh axis that carries no batch)."""
        if tp_dim is not None and not p.placements[self.model_dim].is_shard(tp_dim):
            raise ValueError(f"weight placed {p.placements} has no model shard on dim {tp_dim}")
        keep = tuple(i == self.model_dim and tp_dim is not None for i in range(len(self.names)))
        part = tuple(i in self.batch_dims or (i == self.model_dim and tp_dim is None and partial)
                     for i in range(len(self.names)))
        return _GatherWeight.apply(p, self.groups, keep, part)

    def tp_shard(self, p, dim: int) -> bool:
        """Whether weight ``p`` is sharded over "model" on ``dim``."""
        return p.placements[self.model_dim].is_shard(dim)

    # ------------------------------------------------------------ activations

    # ``seq``: whether the residual [B, S, H] is sharded on S (``seq_sharded``)

    def tp_in(self, h: torch.Tensor, seq: bool) -> torch.Tensor:
        """The whole input [B, S, H] of a sublayer whose model ranks each
        compute a part (TP heads or columns, or a part of the output rows):
        the rows gathered from their sequence shards (backward:
        reduce-scatter), or the replicated rows through Megatron's f."""
        if seq:
            return _Gather.apply(h, 1, self.group, True)
        return _ReduceInBackward.apply(h, self.group)

    def tp_out(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        """Partial sums [B, S, H] of a row-parallel product, summed: onto the
        sequence shards (reduce-scatter) or on every rank (all-reduce)."""
        if seq:
            return _ReduceScatter.apply(y, 1, self.group)
        return _AllReduce.apply(y, self.group)

    def rep_in(self, h: torch.Tensor, seq: bool) -> torch.Tensor:
        """The whole input of a sublayer every model rank computes whole."""
        return _Gather.apply(h, 1, self.group, True) if seq else h

    def rep_out(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        """The output of such a sublayer in the residual's layout."""
        return _chunk(y, 1, self.group) if seq else y

    def seq_local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence shard of replicated rows [B, S, ...]."""
        return _chunk(x, 1, self.group)

    def seq_full(self, x: torch.Tensor) -> torch.Tensor:
        """Sequence shards [B, S/M, H] gathered, for a computation every
        model rank does whole (backward: this rank's chunk)."""
        return _Gather.apply(x, 1, self.group, False)

    def vocab_full(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-sharded logits [B, S, V/M] gathered over "model" (backward:
        this rank's chunk; the loss is the same on every model rank)."""
        return _Gather.apply(logits, 2, self.group, False)

    # ------------------------------------------------------------------ batch

    def batch_ranks(self) -> int:
        n = 1
        for d in self.batch_dims:
            n *= self.mesh.size(d)
        return n

    def sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch axes (no autograd; a new tensor)."""
        return all_reduce_over(t.detach().clone(), self.mesh, self.batch_dims)

    def sum_over_mesh(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the batch axes and "model" (no autograd)."""
        return all_reduce_over(t, self.mesh, (*self.batch_dims, self.model_dim))
