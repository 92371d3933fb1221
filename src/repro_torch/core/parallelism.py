"""Adaptive Parallelism Interface (PALM §IV-B, Table III, Fig. 8).

Users configure, per the paper:

* **PP** — number of stages + stage binding (op ids -> tile ids), or the
  default FLOPs-balanced contiguous split; GPipe / 1F1B schedule choice.
* **TP/DP** — per-operator parallelism degrees: ``(b, m, n, k)`` for
  Linear, ``(b, c, i, k)`` for Conv/Pool, ``(N_d, N_m)`` for
  Transformer-family ops (Megatron split). Collective-communication
  events are *generated automatically* from Table III.
* **Spatial mapping** — Line vs S-shaped stage layout (Fig. 8) and
  TP-communication-group placement (comm1 = TP neighbours topologically
  close, comm2 = spread), which the paper shows is worth >= 2x.

Note on Table III row 1 (Linear): the printed GU column ``(NK/nk, b),
(NK/nk, m)`` is dimensionally inconsistent with the weight shape (M, K);
we implement the mathematically forced version — dW all-reduce of size
``MK/mk`` over the ``b``- and ``n``-groups, dX all-reduce of size
``BNK/bnk`` over the ``m``-groups in BD — and keep the paper's phase
attribution (weight-gradient sync in GU).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .enums import Layout, Schedule
from .graph import (
    Attention,
    ComputationGraph,
    Conv2,
    Embedding,
    Linear,
    MoELayer,
    Norm,
    Op,
    Pool,
    SSMScan,
    TransformerLayer,
)
from .hardware import HardwareSpec, Mesh2D

__all__ = [
    "FD", "BD", "GU",
    "CommTask",
    "SplitOp",
    "ParallelPlan",
    "plan_sort_key",
    "StageMapping",
    "MappedGraph",
    "split_op",
    "line_layout",
    "s_shape_layout",
    "make_groups",
    "map_graph",
]

FD, BD, GU = "FD", "BD", "GU"


@dataclass
class CommTask:
    """One collective generated by an operator under a parallelism config.

    ``elems`` is the per-participant payload in elements; ``axis`` names
    the degree dimension whose groups perform the collective.
    """

    phase: str                    # FD | BD | GU
    kind: str                     # all_reduce | all_gather | reduce_scatter | all_to_all
    elems: float
    axis: str

    def bytes(self, precision: int) -> float:
        return self.elems * precision


@dataclass
class SplitOp:
    """An operator split across a tile group of ``P`` devices."""

    op: Op
    degrees: Dict[str, int]
    fwd_flops_tile: float
    bwd_flops_tile: float
    weight_elems_tile: float
    act_in_elems_tile: float
    act_out_elems_tile: float
    comms: List[CommTask]
    matmul_fraction: float = 1.0

    @property
    def P(self) -> int:
        return int(math.prod(self.degrees.values())) if self.degrees else 1


def _degree(degrees: Dict[str, int], key: str) -> int:
    return max(1, int(degrees.get(key, 1)))


def split_op(op: Op, degrees: Dict[str, int]) -> SplitOp:
    """Split ``op`` by its parallelism degrees; emit Table III comm tasks."""
    comms: List[CommTask] = []
    P = max(1, int(math.prod(max(1, v) for v in degrees.values()))) if degrees else 1

    if isinstance(op, Linear):
        b, m, n, k = (_degree(degrees, a) for a in "bmnk")
        P = b * m * n * k
        if k > 1:
            comms.append(CommTask(FD, "all_reduce", op.B * op.M * op.N / (b * m * n), "k"))
        if m > 1:
            comms.append(CommTask(BD, "all_reduce", op.B * op.N * op.K / (b * n * k), "m"))
        for axis, deg in (("b", b), ("n", n)):
            if deg > 1:
                comms.append(CommTask(GU, "all_reduce", op.M * op.K / (m * k), axis))
        weight_tile = op.param_count() / (m * k)

    elif isinstance(op, (Conv2, Pool)):
        b, c, i, k = (_degree(degrees, a) for a in "bcik")
        P = b * c * i * k
        if isinstance(op, Conv2):
            if c > 1:
                comms.append(CommTask(FD, "all_reduce",
                                      op.B * op.H_out * op.W_out * op.K / (b * i * k), "c"))
            if k > 1:
                comms.append(CommTask(BD, "all_reduce",
                                      op.B * op.H * op.W * op.C / (b * i * c), "k"))
            for axis, deg in (("b", b), ("i", i)):
                if deg > 1:
                    comms.append(CommTask(GU, "all_reduce", op.param_count() / (c * k), axis))
            weight_tile = op.param_count() / (c * k)
        else:
            weight_tile = 0.0

    elif isinstance(op, TransformerLayer):
        dp, tp = _degree(degrees, "dp"), _degree(degrees, "tp")
        P = dp * tp
        if tp > 1:
            # Megatron: one all-reduce after attention + one after MLP (FD),
            # mirrored in BD  =>  Table III row 4: (2BSH/Nd, Nm).
            comms.append(CommTask(FD, "all_reduce", 2.0 * op.B * op.S * op.H / dp, "tp"))
            comms.append(CommTask(BD, "all_reduce", 2.0 * op.B * op.S * op.H / dp, "tp"))
        if dp > 1:
            comms.append(CommTask(GU, "all_reduce", op.param_count() / tp, "dp"))
        weight_tile = op.param_count() / tp

    elif isinstance(op, (Attention,)):
        dp, tp = _degree(degrees, "dp"), _degree(degrees, "tp")
        P = dp * tp
        # decode attention: heads are TP-split; output gather only if the
        # consumer needs full heads (Megatron folds it into out-proj) -> none
        weight_tile = 0.0

    elif isinstance(op, MoELayer):
        dp, ep = _degree(degrees, "dp"), _degree(degrees, "tp")  # tp axis hosts experts
        P = dp * ep
        if ep > 1:
            a2a = op.B * op.S * op.top_k * op.H / dp
            comms.append(CommTask(FD, "all_to_all", a2a, "tp"))   # dispatch
            comms.append(CommTask(FD, "all_to_all", a2a, "tp"))   # combine
            comms.append(CommTask(BD, "all_to_all", a2a, "tp"))
            comms.append(CommTask(BD, "all_to_all", a2a, "tp"))
        if dp > 1:
            comms.append(CommTask(GU, "all_reduce", op.param_count() / ep, "dp"))
        weight_tile = op.param_count() / ep

    elif isinstance(op, SSMScan):
        dp, tp = _degree(degrees, "dp"), _degree(degrees, "tp")
        P = dp * tp
        if tp > 1:
            # out_proj row-parallel reduction, once per block
            comms.append(CommTask(FD, "all_reduce", op.B * op.S * op.H / dp, "tp"))
            comms.append(CommTask(BD, "all_reduce", op.B * op.S * op.H / dp, "tp"))
        if dp > 1:
            comms.append(CommTask(GU, "all_reduce", op.param_count() / tp, "dp"))
        weight_tile = op.param_count() / tp

    elif isinstance(op, Embedding):
        dp, tp = _degree(degrees, "dp"), _degree(degrees, "tp")
        P = dp * tp
        if tp > 1:  # vocab-split embedding: partial rows all-reduced
            comms.append(CommTask(FD, "all_reduce", op.B * op.S * op.H / dp, "tp"))
        if dp > 1:
            comms.append(CommTask(GU, "all_reduce", op.param_count() / tp, "dp"))
        weight_tile = op.param_count() / tp

    elif isinstance(op, Norm):
        dp, tp = _degree(degrees, "dp"), _degree(degrees, "tp")
        P = dp * tp
        if dp > 1:
            comms.append(CommTask(GU, "all_reduce", op.param_count(), "dp"))
        weight_tile = op.param_count()

    else:
        raise TypeError(f"unknown op type {type(op).__name__}")

    return SplitOp(
        op=op,
        degrees={k: v for k, v in degrees.items() if v > 1} or {"_": 1},
        fwd_flops_tile=op.fwd_flops() / P,
        bwd_flops_tile=op.bwd_flops() / P,
        weight_elems_tile=weight_tile,
        act_in_elems_tile=op.in_elems() / P,
        act_out_elems_tile=op.out_elems() / P,
        comms=comms,
        matmul_fraction=op.matmul_fraction,
    )


# ---------------------------------------------------------------------------
# Spatial mapping (Fig. 8)
# ---------------------------------------------------------------------------

def line_layout(topo: Mesh2D, num_stages: int) -> List[List[int]]:
    """Line layout: pipeline arranged vertically, stages = row bands."""
    order = [topo.device(r, c) for r in range(topo.rows) for c in range(topo.cols)]
    return _chunk(order, num_stages)


def s_shape_layout(topo: Mesh2D, num_stages: int) -> List[List[int]]:
    """S-shaped (serpentine) layout: consecutive stages stay adjacent and
    tile groups stay compact (Fig. 8 right)."""
    order: List[int] = []
    for r in range(topo.rows):
        cols = range(topo.cols) if r % 2 == 0 else range(topo.cols - 1, -1, -1)
        order.extend(topo.device(r, c) for c in cols)
    return _chunk(order, num_stages)


def _chunk(order: Sequence[int], n: int) -> List[List[int]]:
    size = len(order) // n
    if size == 0:
        raise ValueError(f"cannot place {n} stages on {len(order)} tiles")
    out = [list(order[i * size:(i + 1) * size]) for i in range(n)]
    # distribute remainder onto the last stage
    rem = len(order) - size * n
    if rem:
        out[-1].extend(order[-rem:])
    return out


def make_groups(
    devices: Sequence[int],
    degrees: Dict[str, int],
    axis_order: Optional[List[str]] = None,
) -> Dict[str, List[List[int]]]:
    """Partition a tile group into per-axis communication groups.

    ``axis_order[-1]`` is the *innermost* (contiguous) axis: putting
    ``"tp"`` last realises the paper's comm1 (TP groups topologically
    close); putting it first realises comm2.
    """
    degrees = {k: v for k, v in degrees.items() if v > 1}
    if not degrees:
        return {}
    axis_order = axis_order or list(degrees.keys())
    axis_order = [a for a in axis_order if a in degrees]
    shape = [degrees[a] for a in axis_order]
    total = math.prod(shape)
    if total > len(devices):
        raise ValueError(f"degrees {degrees} need {total} tiles, got {len(devices)}")
    devs = list(devices)[:total]

    groups: Dict[str, List[List[int]]] = {a: [] for a in axis_order}
    strides = {}
    s = 1
    for a in reversed(axis_order):
        strides[a] = s
        s *= degrees[a]
    for a in axis_order:
        deg, stride = degrees[a], strides[a]
        n_groups = total // deg
        seen = set()
        for base in range(total):
            # base index with axis-a coordinate zero
            if (base // stride) % deg != 0:
                continue
            key = base
            if key in seen:
                continue
            seen.add(key)
            groups[a].append([devs[base + j * stride] for j in range(deg)])
        assert len(groups[a]) == n_groups
    return groups


# ---------------------------------------------------------------------------
# Plan + mapped graph
# ---------------------------------------------------------------------------

@dataclass
class ParallelPlan:
    """User-facing parallelism configuration (the Adaptive Parallelism
    Interface of Fig. 2)."""

    pp: int = 1
    dp: int = 1
    tp: int = 1
    interleave: int = 1                 # virtual stages per tile group
                                        # (interleaved 1F1B, Table II)
    microbatch: int = 1                 # micro-batch size b
    global_batch: int = 1               # mini-batch B (gradient-update period)
    schedule: Schedule = Schedule.ONE_F_ONE_B
    layout: Layout = Layout.S_SHAPE
    tp_contiguous: bool = True          # comm1 (True) vs comm2 (False)
    optimizer: str = "adam"             # "adam" | "sgd"
    zero: int = 0                       # ZeRO stage 0..3 [48]
    dataflow: str = "auto"              # "auto" | "ws" | "is" (Alg. 1)
    recompute: str = "auto"             # "auto" | "always" | "never"
    activation_offload: bool = False    # park saved activations in host/pool
                                        # memory between FD and BD: per-tile
                                        # footprint keeps 1 in-flight micro-
                                        # batch, at the cost of a DRAM store
                                        # after FD + load before BD
    stage_binding: Optional[List[List[int]]] = None   # op ids per stage
    tile_binding: Optional[List[List[int]]] = None    # tile ids per stage
    comm_strategy: int = 1              # inter-tile-group strategy (Fig. 11)
    training: bool = True
    stream_overlap: bool = True         # double-buffer DRAM streams w/ compute
    weight_multicast: bool = True       # one DRAM stream per weight shard,
                                        # multicast to DP replicas over NoC

    def __post_init__(self):
        self.schedule = Schedule(self.schedule)
        self.layout = Layout(self.layout)

    @property
    def num_microbatches(self) -> int:
        """Pipeline iterations per mini-batch: each DP replica consumes
        ``global_batch / dp`` samples in chunks of ``microbatch``."""
        return max(1, self.global_batch // max(1, self.microbatch * self.dp))

    def degrees_for(self, op: Op) -> Dict[str, int]:
        if isinstance(op, Linear):
            # fold (dp, tp) onto (b, m): batch-split + output-row split
            return {"b": self.dp, "m": self.tp, "n": 1, "k": 1}
        if isinstance(op, (Conv2, Pool)):
            return {"b": self.dp, "c": 1, "i": 1, "k": self.tp}
        return {"dp": self.dp, "tp": self.tp}

    @staticmethod
    def axis_alias(op: Op) -> Dict[str, str]:
        """Map op-local degree axes onto the stage-canonical (dp, tp) axes
        so one stage can mix Table III op types in shared comm groups."""
        if isinstance(op, Linear):
            return {"b": "dp", "m": "tp", "n": "tp", "k": "tp"}
        if isinstance(op, (Conv2, Pool)):
            return {"b": "dp", "c": "tp", "i": "dp", "k": "tp"}
        return {}


def plan_sort_key(plan: ParallelPlan) -> str:
    """Canonical total-order key for a plan (JSON of its fields with
    sorted keys). Rankings everywhere — ``sweep_plans`` here and
    :func:`repro_torch.api.report.run_rank_key` in the Experiment layer —
    tie-break equal-throughput runs on this one string so orderings
    never depend on job arrival order (which differs between serial,
    pooled and batched executors)."""
    d = dataclasses.asdict(plan)
    d["schedule"] = str(plan.schedule)
    d["layout"] = str(plan.layout)
    return json.dumps(d, sort_keys=True, default=repr)


@dataclass
class StageMapping:
    """One pipeline stage bound to a tile group."""

    stage_id: int
    op_ids: List[int]
    devices: List[int]
    split_ops: List[SplitOp]
    groups: Dict[str, List[List[int]]]
    degrees: Dict[str, int] = field(default_factory=dict)

    @property
    def weight_shards(self) -> int:
        """Distinct weight shards in the group (DP replicas share shards:
        a single edge-DRAM stream is multicast to replicas)."""
        dp = self.degrees.get("dp", 1)
        return max(1, len(self.devices) // max(1, dp))

    @property
    def fwd_flops_tile(self) -> float:
        return sum(s.fwd_flops_tile for s in self.split_ops)

    @property
    def bwd_flops_tile(self) -> float:
        return sum(s.bwd_flops_tile for s in self.split_ops)

    @property
    def weight_elems_tile(self) -> float:
        return sum(s.weight_elems_tile for s in self.split_ops)


@dataclass
class MappedGraph:
    """Graph after stage partitioning, tile binding, and op splitting."""

    graph: ComputationGraph
    plan: ParallelPlan
    hardware: HardwareSpec
    stages: List[StageMapping]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def boundary_elems(self, stage_id: int) -> float:
        """Activation elements passed from stage ``stage_id`` to the next
        (per micro-batch, per receiving tile)."""
        last_op = self.stages[stage_id].split_ops[-1]
        return last_op.act_out_elems_tile * max(1, self.plan.tp)  # TP-replicated


def map_graph(graph: ComputationGraph, hardware: HardwareSpec, plan: ParallelPlan) -> MappedGraph:
    """Bind stages to tiles and split every op (Fig. 2 center)."""
    num_stages = plan.pp * max(1, plan.interleave)
    # 1. stage partition (user binding or FLOPs-balanced default)
    if plan.stage_binding is not None:
        op_stages = plan.stage_binding
        if len(op_stages) != num_stages:
            raise ValueError("stage_binding length must equal pp*interleave")
    else:
        op_stages = graph.partition_stages(num_stages)

    # 2. tile binding (user binding or layout heuristic); with interleaving
    # virtual stage v lives on physical group v % pp (Megatron interleaved
    # 1F1B: each tile group hosts `interleave` non-contiguous model chunks)
    topo = hardware.topology
    num_chips = getattr(hardware, "num_chips", 1)
    if plan.tile_binding is not None:
        tile_stages = plan.tile_binding
    elif num_chips > 1:
        # cluster machine: lay every chip out with the intra-chip layout
        # heuristic, concatenate in chip order (global id = chip*size +
        # local), and chunk the whole walk into pp stages — so dp/pp
        # groups span chips only when they must.
        if isinstance(topo, Mesh2D):
            fn = s_shape_layout if plan.layout == Layout.S_SHAPE else line_layout
            walk = [d for g in fn(topo, 1) for d in g]
        else:
            walk = list(range(topo.num_devices))
        size = topo.num_devices
        order = [c * size + d for c in range(num_chips) for d in walk]
        tile_stages = _chunk(order, plan.pp)
    elif isinstance(topo, Mesh2D):
        fn = s_shape_layout if plan.layout == Layout.S_SHAPE else line_layout
        tile_stages = fn(topo, plan.pp)
    else:
        tile_stages = _chunk(list(range(topo.num_devices)), plan.pp)
    if plan.interleave > 1:
        tile_stages = [tile_stages[v % plan.pp] for v in range(num_stages)]

    # 3. split ops + build comm groups per stage
    stages: List[StageMapping] = []
    for sid, (op_ids, devices) in enumerate(zip(op_stages, tile_stages)):
        split_ops = []
        for i in op_ids:
            op = graph.ops[i]
            s = split_op(op, plan.degrees_for(op))
            alias = plan.axis_alias(op)
            if alias:  # canonicalise axes so ops share stage comm groups
                s.degrees = {alias.get(a, a): d for a, d in s.degrees.items()}
                for c in s.comms:
                    c.axis = alias.get(c.axis, c.axis)
            split_ops.append(s)
        degrees: Dict[str, int] = {}
        for s in split_ops:
            for a, d in s.degrees.items():
                if a != "_":
                    degrees[a] = max(degrees.get(a, 1), d)
        inner_axes = [a for a in ("tp", "m", "k", "c") if a in degrees]
        outer_axes = [a for a in degrees if a not in inner_axes]
        order = (outer_axes + inner_axes) if plan.tp_contiguous else (inner_axes + outer_axes)
        groups = make_groups(devices, degrees, axis_order=order) if degrees else {}
        # trim to the tiles the parallelism actually occupies (idle tiles
        # must not generate DRAM/NoC traffic — virtual tile aggregation
        # models the active group only)
        active = math.prod(degrees.values()) if degrees else 1
        devices = list(devices)[:max(1, active)]
        stages.append(StageMapping(sid, list(op_ids), devices, split_ops, groups,
                                   degrees=degrees))
    return MappedGraph(graph=graph, plan=plan, hardware=hardware, stages=stages)
