"""Train step and eval step, the counterpart of ``repro.train.step``: on
one device, or FSDP x TP-sharded over a ``DeviceMesh`` with ZeRO-2
(``mesh=``).

The train state keeps three things: the ``LM`` whose compute-dtype weights
the forward reads (and autograd differentiates), the master weights in
``RunCfg.param_dtype`` keyed by parameter name, and the optimizer state.
A step takes the gradients of every microbatch, accumulates them in
``grad_accum_dtype``, updates masters and moments in place (the
reference's donated buffers) and copies the masters into the model.

On a mesh, masters, moments and model weights are DTensors at
``ShardingPlanner``'s placements (the reference's ``in_shardings``), the
batch is sliced to this rank's rows (over ``(pod, data)``, replicated
where B does not divide), and each microbatch's gradients arrive on the
parameters' placements (the backward of the per-layer weight gathers
reduce-scatters them: the reference's ``shard_like_params``), so the
accumulators are shard-sized.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.lm import LM, RunCfg, init_params, loss_fn
from ..obs.registry import span
from ..parallel.comm import is_dtensor, local
from ..parallel.sharding import MeshPlacements, local_rows
from .optim import OptimizerCfg, apply_optimizer, init_opt_state

__all__ = ["TrainCfg", "TrainState", "init_train_state", "make_train_step", "make_eval_step",
           "accumulate_grads", "sync_model", "local_batch"]


@dataclass(frozen=True)
class TrainCfg:
    run: RunCfg = RunCfg()
    opt: OptimizerCfg = OptimizerCfg()
    num_microbatches: int = 1
    grad_accum_dtype: torch.dtype = torch.float32    # bf16 = 340B memory policy


@dataclass
class TrainState:
    """``model``: compute-dtype weights; ``params``: the masters, by
    parameter name; ``opt_state``: {"m", "v", "step"} (``optim``)."""

    model: LM
    params: Dict[str, torch.Tensor]
    opt_state: Dict = field(default_factory=dict)


def _with_mesh_cfg(cfg: TrainCfg, mesh) -> TrainCfg:
    """``cfg`` with its run config on ``mesh``."""
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, mesh=mesh))


@torch.no_grad()
def sync_model(state: TrainState) -> None:
    """Copy the masters into the model's weights (rounded to their types);
    on a mesh, each rank its local shards."""
    with span("host.train.sync_model"):
        for name, w in state.model.named_parameters():
            local(w).copy_(local(state.params[name]))


def init_train_state(arch: ArchConfig, cfg: TrainCfg, generator: torch.Generator,
                     device=None, mesh=None) -> TrainState:
    """Masters drawn by ``init_params`` in ``param_dtype`` (the fp32 draw
    itself, not the compute weights widened again), the model rounded from
    them, and a fresh optimizer state. With ``mesh`` every rank draws the
    same full masters from ``generator`` (on the mesh's device) and keeps
    its shards of each at the planner's placements, so the weights are
    those of the single-device state; the model is built on the mesh."""
    run = _with_mesh_cfg(cfg, mesh).run
    masters = init_params(arch, generator, RunCfg(compute_dtype=run.param_dtype, mesh=mesh),
                          device)
    params = {name: p.detach() for name, p in masters.named_parameters()}
    del masters
    state = TrainState(LM(arch, run, local(next(iter(params.values()))).device), params)
    sync_model(state)
    state.opt_state = init_opt_state(cfg.opt, params)
    return state


def _to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def local_batch(model: LM, batch: Mapping, leading_scan_dim: bool) -> Dict[str, torch.Tensor]:
    """``batch`` (every rank holds all of it) on the model's device, cut to
    this rank's rows on a mesh: the batch dim (1 with a leading microbatch
    dim, else 0) over ``MeshComm.batch_axes`` where it divides them, else
    whole (``parallel.sharding.local_rows``)."""
    batch = _to_device(batch, model.device)
    mesh = model.cfg.mesh
    if mesh is None:
        return batch
    return {k: local_rows(v, mesh, model.comm.batch_axes, leading_scan_dim)
            for k, v in batch.items()}


def accumulate_grads(model: LM, batch: Mapping, cfg: TrainCfg
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict]:
    """Gradients of ``loss_fn`` with respect to the model's weights over
    the G microbatches of ``batch`` (leaves [G, B_mb, ...]): (grads by
    parameter name, loss, metrics). G = 1: the microbatch's own grads (in
    the weights' type) and metrics. G > 1: grads summed in
    ``grad_accum_dtype`` and divided by G, loss summed as l / G, metrics
    averaged (``repro.train.step``'s scan). Each weight's gradient is taken
    into the sum as soon as autograd has it and then dropped, so no second
    set of weight-sized gradients is held beside the sum. On a mesh the
    batch is the whole batch (cut here by ``local_batch``), each gradient
    reaches its hook on the weight's placements, and the grads are
    DTensors there (the sums are this rank's shards)."""
    batch = local_batch(model, batch, leading_scan_dim=True)
    G = cfg.num_microbatches
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}

    def take(name):
        def hook(p):
            g, p.grad = local(p.grad), None
            if G == 1:
                out[name] = g
            elif name in out:
                out[name].add_(g)           # in the accumulator's type
            else:
                out[name] = g.to(cfg.grad_accum_dtype, copy=True)
        return hook

    for p in params.values():
        p.grad = None
    handles = [p.register_post_accumulate_grad_hook(take(n)) for n, p in params.items()]
    loss_acc, per_mb = torch.zeros((), device=model.device), []
    try:
        for i in range(G):
            with span("host.train.forward"):
                loss, metrics = loss_fn(model, {k: v[i] for k, v in batch.items()})
            with span("host.train.backward"):     # waits for autograd's device thread
                loss.backward()
            loss_acc = loss_acc + metrics["loss"].detach() / G
            per_mb.append({k: m.detach() for k, m in metrics.items()})
            del loss, metrics
    finally:
        for h in handles:
            h.remove()
    missing = sorted(set(params) - set(out))
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    grads = {n: _placed_like(out[n], params[n]) for n in params}
    if G == 1:
        return grads, per_mb[0]["loss"], per_mb[0]
    with torch.no_grad():
        for g in grads.values():
            local(g).div_(G)
    return grads, loss_acc, {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A local gradient shard as a DTensor at ``p``'s placements (``p`` a
    DTensor), else ``g``."""
    if not is_dtensor(p):
        return g
    return MeshPlacements(p.device_mesh, tuple(p.placements)).wrap(g, p.shape)


def make_train_step(arch: ArchConfig, cfg: TrainCfg, mesh=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; batch leaves carry
    a leading microbatch axis [G, B_mb, ...] (G == cfg.num_microbatches),
    as numpy arrays or tensors, the whole batch on every rank of a mesh.
    ``state`` is updated in place and returned. metrics: the loss_fn
    metrics, "lr", "grad_norm" and "loss". With ``mesh`` the state must be
    ``init_train_state(..., mesh=mesh)``'s (its model carries the mesh)."""
    del arch     # the model carries it

    def train_step(state: TrainState, batch):
        if state.model.cfg.mesh is not mesh:
            raise ValueError("the train state's model is not on this step's mesh")
        grads, loss, metrics = accumulate_grads(state.model, batch, cfg)
        om = apply_optimizer(cfg.opt, state.params, grads, state.opt_state)
        del grads
        sync_model(state)
        return state, {**metrics, **om, "loss": loss}

    return train_step


def make_eval_step(arch: ArchConfig, cfg: TrainCfg, mesh=None) -> Callable:
    """``eval_step(model, batch) -> metrics`` on one batch [B, ...] (the
    whole batch on every rank of a mesh; the model built on ``mesh``)."""
    del arch, cfg

    @torch.no_grad()
    def eval_step(model: LM, batch):
        if model.cfg.mesh is not mesh:
            raise ValueError("the model is not on this step's mesh")
        _, metrics = loss_fn(model, local_batch(model, batch, leading_scan_dim=False))
        return metrics

    return eval_step
