"""Optimizers (Adam / SGD), the counterpart of ``repro.train.optim``:
the schedule, the global norm and the update, math in fp32, moments stored
in ``moment_dtype``.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``LM.named_parameters()``), and the update is in place (the
reference's step donates its buffers). On a mesh they are DTensors and
each rank updates its shards. The reference decays leaves with
``ndim >= 2`` of its layer-stacked tree, where every per-layer leaf has a
leading L axis: the per-layer norms are [L, H] there and so are decayed,
and only ``final_norm`` is not. ``reference_ndim`` gives that ndim for a
port leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping

import torch

from ..obs.registry import span
from ..parallel.comm import all_reduce_over, is_dtensor, local

__all__ = ["OptimizerCfg", "lr_at", "init_opt_state", "global_norm", "apply_optimizer",
           "reference_ndim"]


@dataclass(frozen=True)
class OptimizerCfg:
    name: str = "adam"                # "adam" | "sgd" (paper Table II)
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 = the 340B memory policy


def lr_at(cfg: OptimizerCfg, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, as an fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """ndim of the leaf in the reference's tree: per-layer leaves
    (``blocks.<i>.*``) carry a leading layer axis there."""
    return p.ndim + (1 if name.startswith("blocks.") else 0)


def init_opt_state(cfg: OptimizerCfg, params: Mapping[str, torch.Tensor]) -> Dict:
    """{"m", "v": per-leaf moments (0-d stubs for SGD), "step": int32 0}.
    Moments of DTensor parameters are DTensors at the same placements (each
    rank holds its shards); the step is a plain tensor on every rank."""
    if cfg.name == "sgd":
        stub = lambda p: torch.zeros((), dtype=p.dtype, device=local(p).device)
        moments = lambda: {n: stub(p) for n, p in params.items()}
    else:
        moments = lambda: {n: torch.zeros_like(p, dtype=cfg.moment_dtype)
                           for n, p in params.items()}
    device = local(next(iter(params.values()))).device
    return {"m": moments(), "v": moments(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32. DTensor leaves
    (one mesh) count each distinct element once: a leaf's local sum of
    squares counts on the ranks at coordinate 0 of every mesh dim it is
    replicated over, and the per-leaf sums are all-reduced over the mesh
    before they are added up in leaf order, as on one device."""
    leaves = list(tree.values())
    if not any(is_dtensor(x) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    mesh = next(x.device_mesh for x in leaves if is_dtensor(x))
    coord = mesh.get_coordinate()
    sums = []
    for x in leaves:
        s = torch.sum(torch.square(local(x).to(torch.float32)))
        replica = is_dtensor(x) and any(not pl.is_shard() and coord[i]
                                        for i, pl in enumerate(x.placements))
        sums.append(torch.zeros_like(s) if replica else s)
    per_leaf = all_reduce_over(torch.stack(sums), mesh, range(mesh.ndim))
    return torch.sqrt(sum(per_leaf.unbind()))


@torch.no_grad()
def apply_optimizer(cfg: OptimizerCfg, params: Dict[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], state: Dict) -> Dict[str, torch.Tensor]:
    """Update ``params`` and ``state`` in place; returns {"lr", "grad_norm"}.
    Math in fp32 (lr, c1, c2 and the clip scale are fp32 tensors), storage
    at the params' and moments' dtypes. The reference's expressions, with
    the moments and parameters updated in place, so a leaf's update holds
    at most three leaf-sized fp32 temporaries. DTensor leaves (parameters,
    gradients and moments at the same placements) update each rank's
    local shards; only the global norm communicates."""
    with span("host.train.apply_optimizer"):
        return _update(cfg, params, grads, state)


def _update(cfg: OptimizerCfg, params: Dict[str, torch.Tensor],
            grads: Mapping[str, torch.Tensor], state: Dict) -> Dict[str, torch.Tensor]:
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip > 0
             else 1.0)
    state["step"] = step
    f32 = torch.float32
    if cfg.name == "sgd":
        for n, leaf in params.items():
            p = local(leaf)
            _store(p, p.to(f32).sub_(lr * (local(grads[n]).to(f32) * scale)))
        return {"lr": lr, "grad_norm": gnorm}

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=step.device), step.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=step.device), step.to(f32))
    for n, leaf in params.items():
        p, m, v = local(leaf), local(state["m"][n]), local(state["v"][n])
        g32 = local(grads[n]).to(f32) * scale
        # the reference's order of roundings: no fused multiply-adds
        m32 = _f32(m).mul_(b1).add_((1 - b1) * g32)
        v32 = _f32(v).mul_(b2).add_(((1 - b2) * g32).mul_(g32))
        _store(m, m32)
        _store(v, v32)
        del g32
        step_dir = torch.div(v32, c2).sqrt_().add_(cfg.eps)      # sqrt(vhat) + eps
        step_dir = torch.div(m32, c1).div_(step_dir)             # mhat / (...)
        p32 = _f32(p)
        if cfg.weight_decay > 0 and reference_ndim(n, leaf) >= 2:   # decay matrices only
            step_dir.add_(cfg.weight_decay * p32)
        _store(p, p32.sub_(step_dir.mul_(lr)))
    return {"lr": lr, "grad_norm": gnorm}


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if fp32 (updated in place), else an fp32 copy."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _store(dst: torch.Tensor, value: torch.Tensor) -> None:
    if value is not dst:
        dst.copy_(value)
