"""Single-device train step and eval step, the counterpart of
``repro.train.step`` without its mesh and ZeRO branches (they come with
distribution, ROADMAP queue 1).

The train state keeps three things: the ``LM`` whose compute-dtype weights
the forward reads (and autograd differentiates), the master weights in
``RunCfg.param_dtype`` keyed by parameter name, and the optimizer state.
A step takes the gradients of every microbatch, accumulates them in
``grad_accum_dtype``, updates masters and moments in place (the
reference's donated buffers) and copies the masters into the model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.lm import LM, RunCfg, init_params, loss_fn
from .optim import OptimizerCfg, apply_optimizer, init_opt_state

__all__ = ["TrainCfg", "TrainState", "init_train_state", "make_train_step", "make_eval_step",
           "accumulate_grads", "sync_model"]


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


@torch.no_grad()
def sync_model(state: TrainState) -> None:
    """Copy the masters into the model's weights (rounded to their types)."""
    for name, w in state.model.named_parameters():
        w.copy_(state.params[name])


def init_train_state(arch: ArchConfig, cfg: TrainCfg, generator: torch.Generator,
                     device=None) -> TrainState:
    """Masters drawn by ``init_params`` in ``param_dtype`` (the fp32 draw
    itself, not the compute weights widened again), the model rounded from
    them, and a fresh optimizer state."""
    run = cfg.run
    masters = init_params(arch, generator, RunCfg(compute_dtype=run.param_dtype), device)
    params = {name: p.detach() for name, p in masters.named_parameters()}
    del masters
    state = TrainState(LM(arch, run, next(iter(params.values())).device), params)
    sync_model(state)
    state.opt_state = init_opt_state(cfg.opt, params)
    return state


def _to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def accumulate_grads(model: LM, batch: Mapping, cfg: TrainCfg
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict]:
    """Gradients of ``loss_fn`` with respect to the model's weights over
    the G microbatches of ``batch`` (leaves [G, B_mb, ...]): (grads by
    parameter name, loss, metrics). G = 1: the microbatch's own grads (in
    the weights' type) and metrics. G > 1: grads summed in
    ``grad_accum_dtype`` and divided by G, loss summed as l / G, metrics
    averaged (``repro.train.step``'s scan). Each weight's gradient is taken
    into the sum as soon as autograd has it and then dropped, so no second
    set of weight-sized gradients is held beside the sum."""
    batch = _to_device(batch, model.device)
    G = cfg.num_microbatches
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}

    def take(name):
        def hook(p):
            g, p.grad = p.grad, None
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
            loss, metrics = loss_fn(model, {k: v[i] for k, v in batch.items()})
            loss.backward()
            loss_acc = loss_acc + loss.detach() / G
            per_mb.append({k: m.detach() for k, m in metrics.items()})
            del loss, metrics
    finally:
        for h in handles:
            h.remove()
    missing = sorted(set(params) - set(out))
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    grads = {n: out[n] for n in params}
    if G == 1:
        return grads, per_mb[0]["loss"], per_mb[0]
    with torch.no_grad():
        for g in grads.values():
            g.div_(G)
    return grads, loss_acc, {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}


def make_train_step(arch: ArchConfig, cfg: TrainCfg) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; batch leaves carry
    a leading microbatch axis [G, B_mb, ...] (G == cfg.num_microbatches),
    as numpy arrays or tensors. ``state`` is updated in place and returned.
    metrics: the loss_fn metrics, "lr", "grad_norm" and "loss"."""
    del arch     # the model carries it

    def train_step(state: TrainState, batch):
        grads, loss, metrics = accumulate_grads(state.model, batch, cfg)
        om = apply_optimizer(cfg.opt, state.params, grads, state.opt_state)
        del grads
        sync_model(state)
        return state, {**metrics, **om, "loss": loss}

    return train_step


def make_eval_step(arch: ArchConfig, cfg: TrainCfg) -> Callable:
    """``eval_step(model, batch) -> metrics`` on one batch [B, ...]."""
    del arch, cfg

    @torch.no_grad()
    def eval_step(model: LM, batch):
        _, metrics = loss_fn(model, _to_device(batch, model.device))
        return metrics

    return eval_step
