"""SRAM allocation & DRAM access sizing — PALM Alg. 1 (§IV-C ❶).

Strategies (paper nomenclature):

* ``S_WSG_ACT``  — weights+optimizer+gradients *and* activations resident
  in SRAM: DRAM sees only stage-boundary traffic.
* ``S_WSG`` (``activation_stream``) — WSG resident, activations stream:
  FD access = I + O per op.
* ``S_ACT`` (``weight_stream``)     — activations resident, weights stream:
  FD access = Wt per op (the Cerebras weight-streaming regime [41]).
* ``S_PTY`` (penalty)               — neither fits; weight-stationary vs
  input-stationary chosen by the Φ1/Φ2 comparison; extra DRAM accesses.

Note: as printed, Alg. 1's second guard ``WSG <= S_Cap`` is unreachable
(WSG >= Wt, and the first guard already failed on Wt). The intended guard
is on resident *activations* — we implement ``ACT <= S_Cap`` for the
weight-stream branch and keep the paper's first guard (``Wt`` resident,
extended to WSG when training, since gradients/optimizer state must also
live somewhere during training).

All returned sizes are **bytes**. Weights/activations move at the workload
precision; gradient-update (GU) traffic moves full-precision master
weights + optimizer state (paper: "full-precision weights load from DRAM
and store back").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from .enums import Schedule
from .hardware import HardwareSpec
from .parallelism import ParallelPlan, SplitOp, StageMapping

__all__ = [
    "OpAccess",
    "StageMemory",
    "optimizer_state_bytes_per_param",
    "allocate_stage",
    "stage_memory",
]

FP32 = 4


def optimizer_state_bytes_per_param(optimizer: str) -> int:
    """Adam: fp32 master + m + v (12 B); SGD: none (paper §IV-C ❶)."""
    if optimizer == "adam":
        return 12
    if optimizer == "sgd":
        return 0
    raise ValueError(f"unknown optimizer {optimizer!r}")


@dataclass
class OpAccess:
    """Per-op DRAM traffic (bytes) per micro-batch, per phase.

    Weight traffic is tracked separately from activation traffic: weight
    shards are identical across DP replicas, so on edge-shared DRAM one
    stream per *distinct shard* is fetched and multicast over the NoC
    (dataflow weight streaming), while activation traffic is per-tile."""

    strategy: str
    fd_act: float = 0.0
    fd_weight: float = 0.0
    bd_act: float = 0.0
    bd_weight: float = 0.0
    gu_bytes: float = 0.0   # per *mini*-batch (one gradient update); weights

    @property
    def fd_bytes(self) -> float:
        return self.fd_act + self.fd_weight

    @property
    def bd_bytes(self) -> float:
        return self.bd_act + self.bd_weight


@dataclass
class StageMemory:
    """Per-tile memory footprint of a stage (bytes).

    ``offload_bytes`` tracks activations parked outside the device
    (``plan.activation_offload``): they are excluded from :attr:`total`,
    which is what both the simulator's recompute decision and the sweep
    engine's pre-simulation memory-cap estimate compare against — so
    offload-aware pruning stays exact by construction."""

    weights: float
    grads: float
    opt_state: float
    act_per_microbatch: float
    inflight_microbatches: int
    offload_bytes: float = 0.0

    @property
    def activations(self) -> float:
        return self.act_per_microbatch * self.inflight_microbatches

    @property
    def total(self) -> float:
        return self.weights + self.grads + self.opt_state + self.activations


def _wsg_bytes(split: SplitOp, plan: ParallelPlan, precision: int) -> float:
    """Weights + optimizer state + weight gradients per tile (bytes)."""
    w = split.weight_elems_tile
    opt = optimizer_state_bytes_per_param(plan.optimizer) if plan.training else 0
    grads = precision if plan.training else 0
    dp_shard = max(1, plan.dp) if plan.zero >= 1 else 1
    return w * precision + (w * opt) / dp_shard + w * grads / (dp_shard if plan.zero >= 2 else 1)


def allocate_stage(
    stage: StageMapping,
    plan: ParallelPlan,
    hardware: HardwareSpec,
    recompute: bool = False,
    streaming_acts: Optional[bool] = None,
) -> List[OpAccess]:
    """Alg. 1 over one stage's split ops; returns per-op DRAM bytes.

    ``streaming_acts`` (default: inference pipelines) models dataflow
    execution (Grayskull/wafer style): activations move stage-to-stage
    over the NoC (the Act Pass events), never resting in DRAM, so the
    activation-stream branch charges no DRAM activation traffic and the
    penalty branch only streams weights.
    """
    precision = hardware.precision_bytes
    cap = hardware.tile.sram_bytes
    if streaming_acts is None:
        streaming_acts = not plan.training

    wt_total = sum(s.weight_elems_tile for s in stage.split_ops) * precision
    wsg_total = sum(_wsg_bytes(s, plan, precision) for s in stage.split_ops)
    act_total = sum(s.act_in_elems_tile for s in stage.split_ops) * precision

    resident_w = wsg_total if plan.training else wt_total

    out: List[OpAccess] = []
    for split in stage.split_ops:
        wt = split.weight_elems_tile * precision
        act_in = split.act_in_elems_tile * precision
        act_out = split.act_out_elems_tile * precision
        # GU traffic: full-precision weights load + store (+ Adam moments),
        # sharded by DP under ZeRO >= 1.
        opt_factor = 2 * FP32 + (2 * optimizer_state_bytes_per_param(plan.optimizer)
                                 if plan.optimizer == "adam" else 0)
        gu = split.weight_elems_tile * opt_factor
        if plan.zero >= 1:
            gu /= max(1, plan.dp)
        if not plan.training:
            gu = 0.0

        force = None
        if plan.dataflow == "ws":
            force = "weight_stationary"
        elif plan.dataflow == "is":
            force = "input_stationary"

        fd_a = fd_w = bd_a = bd_w = 0.0
        if force is None and resident_w + act_total <= cap:
            strategy = "sram_resident"          # S_WSG_ACT
        elif force is None and resident_w <= cap:
            strategy = "activation_stream"      # S_WSG
            fd_a = 0.0 if streaming_acts else act_in + act_out
            # BD: read saved input act + incoming out-grad, write in-grad
            bd_a = 2 * act_in + act_out
            if recompute:
                bd_a += act_in + act_out        # re-run FD accesses (Fig. 5)
        elif force is None and act_total <= cap:
            strategy = "weight_stream"          # S_ACT
            fd_w = wt
            # BD: stream weights for dgrad + wgrad, write weight grads
            bd_w = 2 * wt + (wt if plan.training else 0.0)
        elif streaming_acts:
            # dataflow pipeline with oversize weights: stream weights per
            # micro-batch while activations flow on the NoC
            strategy = "weight_stream"
            fd_w = wt
            bd_w = 2 * wt + (wt if plan.training else 0.0)
        else:
            # S_PTY: penalty — tiling, choose WS vs IS by Alg. 1's Φ test
            phi1 = math.ceil(max(wt, 1.0) / cap) * act_in   # weight-stationary
            phi2 = math.ceil(max(act_in, 1.0) / cap) * wt   # input-stationary
            if force == "weight_stationary" or (force is None and phi1 < phi2):
                strategy = "weight_stationary"
                fd_w, fd_a = wt, phi1 + act_out
            else:
                strategy = "input_stationary"
                fd_w, fd_a = phi2, act_in + act_out
            bd_a, bd_w = 2 * fd_a, 2 * fd_w
            if recompute:
                bd_a += fd_a
                bd_w += fd_w

        if plan.training and plan.activation_offload and not recompute:
            # offloaded saved activations: store after FD, fetch before BD
            # (with recompute nothing is saved, so offload is a no-op)
            fd_a += act_in
            bd_a += act_in
        if not plan.training:
            bd_a = bd_w = 0.0
        out.append(OpAccess(strategy=strategy, fd_act=fd_a, fd_weight=fd_w,
                            bd_act=bd_a, bd_weight=bd_w, gu_bytes=gu))
    return out


def stage_memory(stage: StageMapping, plan: ParallelPlan, hardware: HardwareSpec) -> StageMemory:
    """Per-tile memory footprint; encodes the paper's GPipe-vs-1F1B
    activation-capacity difference (§IV-B ❶: first stage stores B
    microbatch activations under GPipe but only S under 1F1B)."""
    precision = hardware.precision_bytes
    weights = sum(s.weight_elems_tile for s in stage.split_ops) * precision
    params = sum(s.weight_elems_tile for s in stage.split_ops)
    dp_shard = max(1, plan.dp) if plan.zero >= 1 else 1
    opt = params * optimizer_state_bytes_per_param(plan.optimizer) / dp_shard \
        if plan.training else 0.0
    grads = params * precision / (max(1, plan.dp) if plan.zero >= 2 else 1) \
        if plan.training else 0.0
    act_mb = sum(s.act_in_elems_tile for s in stage.split_ops) * precision

    num_mb = plan.num_microbatches
    S = plan.pp
    if not plan.training:
        inflight = 1
    elif plan.schedule == Schedule.GPIPE:
        inflight = num_mb
    else:  # 1f1b
        inflight = min(max(1, S - stage.stage_id), num_mb)
    offloaded = 0.0
    if plan.training and plan.activation_offload:
        # saved activations live off-device between FD and BD; only the
        # in-flight micro-batch stays resident
        offloaded = act_mb * max(0, inflight - 1)
        inflight = 1
    return StageMemory(weights=weights, grads=grads, opt_state=opt,
                       act_per_microbatch=act_mb, inflight_microbatches=inflight,
                       offload_bytes=offloaded)
