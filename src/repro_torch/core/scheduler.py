"""Pipeline scheduler with Virtual Tile Aggregation — PALM §IV-A, Figs. 3-5.

Every stage's tile group is represented by *one* simulated worker (the
virtual tile): intra-group tiles have identical compute/memory cost by
construction, so one representative carries the group's timing while the
group-aggregate traffic is what hits shared resources (DRAM ports, NoC
links). This is the paper's O(2N^2) -> O(N^2 + M) -> O(M) reduction; with
``noc_mode="macro"`` the per-collective closed form makes the whole
simulation O(M) events per micro-batch.

Event taxonomy (paper Fig. 4/5): per stage and micro-batch we run
``FD`` (forward), ``BD`` (backward: loss + optional re-computation +
gradient), ``GU`` (gradient update: full-precision weight load/store),
plus ``Act/Grad Pass`` NoC messages that *start* the neighbouring stage,
and ``Data Fetch`` for stage 0. The Prior Selector is realised as the
deterministic 1F1B/GPipe work list; DP gradient collectives are launched
asynchronously so they overlap subsequent compute (Fig. 5 note).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple

from .dram import DRAMModel
from .enums import BoundaryMode, NoCMode, Schedule
from .events import Environment, Event
from .hardware import HardwareSpec
from .noc import NoCModel
from .parallelism import BD, FD, GU, MappedGraph, ParallelPlan, StageMapping
from .sram import OpAccess, StageMemory, allocate_stage, stage_memory
from .trace import (
    KIND_BD,
    KIND_DRAM,
    KIND_FD,
    KIND_GU,
    KIND_NOC,
    Trace,
    TraceRecorder,
)

__all__ = ["SimResult", "PipelineSimulator", "ideal_pipeline_time",
           "decide_recompute", "estimate_stage_memory", "plan_memory"]


@dataclass
class SimResult:
    total_time: float
    throughput: float                  # samples (sequences) / s
    stage_memory: List[StageMemory]
    recompute: bool
    event_count: int
    noc_bytes: float
    dram_bytes: float
    # which tier produced the result: "event" (generator/heap kernel) or
    # "fast" (closed-form analytic tier, repro_torch.core.fastpath). Timing is
    # bit-identical between tiers whenever the fast tier runs, so the
    # provenance tag is excluded from equality. Note ``event_count`` is
    # tier-dependent (heap pops vs chain-node evaluations).
    engine: str = field(default="event", compare=False)
    # columnar event timeline: compute lanes (FD/BD/GU) are always
    # recorded; NoC/DRAM busy-interval lanes when the simulator ran with
    # ``collect_timeline=True``
    trace: Optional[Trace] = None
    # scalar link-utilization digest for runs without resource lanes
    # (legacy behaviour: the field was always populated). In-process
    # convenience only — the sweep engine clears it so serial and pooled
    # sweeps return identical, lean results
    noc_occupancy_fallback: Dict[int, float] = field(
        default_factory=dict, compare=False, repr=False)
    # ``{"sim": ..., "host": ...}`` observability document (repro.obs),
    # attached by ``PipelineSimulator.run`` when metrics are enabled. The
    # "sim" half is derived only from compare=True data and is therefore
    # itself bit-identical across tiers; the "host" half (engine
    # provenance, rejection reasons) is not, so the whole field stays out
    # of equality.
    metrics: Optional[Dict] = field(default=None, compare=False, repr=False)

    @property
    def timeline(self) -> List[Tuple[int, str, int, float, float]]:
        """Deprecated legacy tuple view of the compute lanes; use
        :attr:`trace` (kept one release for downstream tooling)."""
        warnings.warn("SimResult.timeline is deprecated; use SimResult.trace",
                      DeprecationWarning, stacklevel=2)
        return [] if self.trace is None else self.trace.compute_tuples()

    @property
    def stage_busy(self) -> Dict[int, float]:
        """Per-stage FD+BD busy seconds, derived from the trace."""
        return {} if self.trace is None else self.trace.stage_busy()

    @property
    def noc_occupancy(self) -> Dict[int, float]:
        """Per-link busy fraction, sorted by link id: derived from the
        trace's NOC lane when the run collected resource intervals,
        otherwise the scalar utilization digest recorded at run end."""
        occ = ({} if self.trace is None
               else self.trace.resource_occupancy(KIND_NOC))
        return occ or dict(self.noc_occupancy_fallback)

    @property
    def dram_occupancy(self) -> Dict[int, float]:
        """Per-channel busy fraction from the trace's DRAM lane."""
        return ({} if self.trace is None
                else self.trace.resource_occupancy(KIND_DRAM))

    @property
    def bubble_ratio(self) -> float:
        if self.trace is None:
            return 0.0
        return self.trace.bubble_fraction()


def ideal_pipeline_time(fd_bd_per_stage: List[float], num_microbatches: int,
                        gu_time: float = 0.0) -> float:
    """Paper Eq. (1): (B/b - 1) * max_s(FD+BD) + sum_s(FD+BD) + GU."""
    return ((num_microbatches - 1) * max(fd_bd_per_stage)
            + sum(fd_bd_per_stage) + gu_time)


def decide_recompute(memory: List[StageMemory], plan: ParallelPlan,
                     hardware: HardwareSpec) -> bool:
    """Recompute decision (auto: recompute iff some stage's footprint
    exceeds per-device DRAM capacity without it). Shared by the simulator
    and the sweep engine's pre-simulation memory estimate so early pruning
    sees exactly the memory the simulation would report."""
    if plan.recompute == "always":
        return True
    if plan.recompute == "never":
        return False
    cap = hardware.dram.capacity_bytes
    return any(m.total > cap for m in memory)


def plan_memory(mapped: MappedGraph) -> Tuple[List[StageMemory], bool]:
    """Per-stage memory of a mapped graph *before* simulation, with the
    recompute decision applied — identical to ``SimResult.stage_memory``.
    This is what makes memory-cap feasibility a pre-simulation check; the
    result can be handed to :class:`PipelineSimulator` (``memory_plan``)
    so a capped sweep sizes memory only once per plan."""
    plan, hw = mapped.plan, mapped.hardware
    memory = [stage_memory(st, plan, hw) for st in mapped.stages]
    recompute = decide_recompute(memory, plan, hw)
    if recompute:
        for m in memory:
            m.inflight_microbatches = 1  # only boundary acts retained
            m.offload_bytes = 0.0        # nothing saved => nothing offloaded
    return memory, recompute


def estimate_stage_memory(mapped: MappedGraph) -> List[StageMemory]:
    return plan_memory(mapped)[0]


class PipelineSimulator:
    """Runs one training iteration (or an inference pipeline) of a mapped
    graph and reports absolute time + throughput.

    The FD/BD/GU compute lanes of ``SimResult.trace`` are always recorded
    (they are tiny — O(stages x micro-batches) rows — and feed the scalar
    busy/bubble digests); ``collect_timeline=True`` additionally records
    NoC-link and DRAM-channel busy intervals into the trace's resource
    lanes."""

    def __init__(
        self,
        mapped: MappedGraph,
        noc_mode: NoCMode = NoCMode.MACRO,
        collect_timeline: bool = False,
        boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE,
        memory_plan: Optional[Tuple[List[StageMemory], bool]] = None,
        engine: str = "event",
        metrics: bool = False,
    ):
        if engine not in ("event", "auto", "fast"):
            raise ValueError(f"unknown engine {engine!r} "
                             "(expected 'event', 'auto' or 'fast')")
        self.engine = engine
        self.metrics = bool(metrics)
        self.mapped = mapped
        self.plan: ParallelPlan = mapped.plan
        self.hw: HardwareSpec = mapped.hardware
        self.env = Environment()
        # compute lanes (FD/BD/GU) are always recorded — they are what the
        # scalar stage-busy/bubble digests derive from; ``collect_timeline``
        # additionally records NoC-link / DRAM-channel busy intervals
        self.recorder = TraceRecorder()
        self.collect_timeline = collect_timeline
        res_rec = self.recorder if collect_timeline else None
        if getattr(self.hw, "fabric", None) is not None:
            # multi-chip machine: the fabric facade owns one NoC + DRAM
            # per chip and routes chip-spanning traffic over the scale-out
            # links. Single-chip specs keep the plain models (bit-identical).
            from ..fabric.model import FabricModel

            self.noc = FabricModel(self.env, self.hw, mode=NoCMode(noc_mode),
                                   recorder=res_rec)
            self.dram = self.noc.dram
        else:
            self.noc = NoCModel(self.env, self.hw, mode=NoCMode(noc_mode),
                                recorder=res_rec)
            self.dram = DRAMModel(self.env, self.hw, self.noc,
                                  recorder=res_rec)
        if self.metrics and hasattr(self.noc, "level_bytes"):
            # ask the fabric (both tiers) to attribute payload per level
            self.noc.metrics_levels = True
        self.boundary_mode = BoundaryMode(boundary_mode)

        S = mapped.num_stages
        # Act/Grad Pass mailboxes are event-kernel state: their creation
        # (O(stages x micro-batches) Event objects) is deferred to
        # ``_run_event`` so fast-tier-only runs — the common case in
        # batched sweeps — never pay for them
        self.act_ready: List[List[Event]] = []
        self.grad_ready: List[List[Event]] = []

        # memory + recompute decision (auto: recompute iff footprint exceeds
        # per-device DRAM capacity without it); callers that already sized
        # memory for feasibility pruning pass it in via ``memory_plan``
        self.memory, self.recompute = memory_plan or plan_memory(mapped)

        self.access: List[List[OpAccess]] = [
            allocate_stage(st, self.plan, self.hw, recompute=self.recompute)
            for st in mapped.stages]

        self._fd_done_t: Dict[Tuple[int, int], float] = {}
        # event causality: trace row index per compute event, last row per
        # stage proc, and last releaser row per shared compute resource —
        # what makes ``Trace.critical_path()`` exact under contention
        self._row_idx: Dict[Tuple[int, int, int], int] = {}
        self._prev_row: List[int] = [-1] * S
        self._last_res_row: Dict[Tuple[int, ...], int] = {}
        self._gu_done: List[Event] = []
        # interleaved 1F1B: virtual stages sharing a tile group serialize
        # on the group's compute resource (BD pre-empts queued FD — the
        # Prior Selector, Fig. 4)
        from .events import PriorityResource
        self._compute_res: Dict[Tuple[int, ...], PriorityResource] = {}
        if self.plan.interleave > 1:
            for st in mapped.stages:
                key = tuple(st.devices)
                if key not in self._compute_res:
                    self._compute_res[key] = PriorityResource(
                        self.env, capacity=1, name=f"tiles{st.stage_id % self.plan.pp}")

    def _acquire_compute(self, sid: int, priority: int):
        key = tuple(self.mapped.stages[sid].devices)
        res = self._compute_res.get(key)
        if res is None:
            return None, None
        req = res.request(priority)
        return res, req

    # -- cost primitives -----------------------------------------------------
    def _compute_time(self, flops_tile: float, matmul_fraction: float) -> float:
        tile = self.hw.tile
        mm = flops_tile * matmul_fraction
        vec = flops_tile - mm
        return tile.matmul_time(mm) + (tile.vector_time(vec) if vec > 0 else 0.0)

    def _dram_and_compute(self, stage: StageMapping, act_bytes: float,
                          weight_bytes: float, compute_s: float) -> Generator:
        """One op's DRAM traffic + compute. With ``stream_overlap`` (the
        dataflow double-buffering norm) they run concurrently; otherwise
        sequentially, as Fig. 5's sub-process chain."""
        env = self.env
        if act_bytes + weight_bytes <= 0:
            yield env.timeout(compute_s)
            return
        shards = stage.weight_shards if self.plan.weight_multicast \
            else len(stage.devices)
        dram = env.process(self.dram.group_access(
            stage.devices, act_bytes, priority=1,
            shared_bytes=weight_bytes, num_shards=shards))
        if self.plan.stream_overlap:
            compute = env.timeout(compute_s)
            yield env.all_of([dram, compute])
        else:
            yield dram
            yield env.timeout(compute_s)

    def _stage_collectives(self, stage: StageMapping, comms, phase: str,
                           priority: int) -> Generator:
        """Run one op's intra-stage collectives for ``phase`` (all groups of
        the axis operate concurrently)."""
        env = self.env
        precision = self.hw.precision_bytes
        procs = []
        for task in comms:
            if task.phase != phase:
                continue
            groups = stage.groups.get(task.axis)
            if not groups:
                continue
            # task.elems is already the per-participant payload (Table III)
            per_dev_bytes = task.elems * precision
            for g in groups:
                procs.append(env.process(
                    self.noc.collective(task.kind, g, per_dev_bytes, priority)))
        if procs:
            yield env.all_of(procs)
        else:
            yield env.timeout(0.0)

    # -- FD / BD / GU bodies (Fig. 5) ------------------------------------------
    def _run_fd(self, sid: int, mb: int) -> Generator:
        stage = self.mapped.stages[sid]
        env = self.env
        t_enter = env.now
        yield self.act_ready[sid][mb]
        t_ready = env.now
        res, req = self._acquire_compute(sid, priority=1)   # FD after BD
        if req is not None:
            yield req
        start = env.now
        # causality: what bound this event's start? (priority order:
        # contended compute resource > upstream Act Pass > stage order)
        if res is not None and start > t_ready:
            pred = self._last_res_row.get(tuple(stage.devices), -1)
        elif t_ready > t_enter and sid > 0:
            pred = self._row_idx.get((sid - 1, KIND_FD, mb), -1)
        else:
            pred = self._prev_row[sid]
        if sid == 0 and stage.split_ops:
            # Data Fetch: input micro-batch from DRAM
            first = stage.split_ops[0]
            nbytes = first.act_in_elems_tile * self.hw.precision_bytes
            yield env.process(self.dram.group_access(stage.devices, nbytes))
        for split, acc in zip(stage.split_ops, self.access[sid]):
            yield from self._dram_and_compute(
                stage, acc.fd_act, acc.fd_weight,
                self._compute_time(split.fwd_flops_tile, split.matmul_fraction))
            yield from self._stage_collectives(stage, split.comms, FD, priority=1)
        self._fd_done_t[(sid, mb)] = env.now
        row = self.recorder.compute(sid, KIND_FD, mb, start, env.now, pred)
        self._row_idx[(sid, KIND_FD, mb)] = row
        self._prev_row[sid] = row
        if res is not None:
            self._last_res_row[tuple(stage.devices)] = row
            res.release(req)
        # Act Pass -> next stage (start signal)
        if sid + 1 < self.mapped.num_stages:
            yield from self._boundary_pass(sid, sid + 1, mb, kind="act")
            self.act_ready[sid + 1][mb].succeed()
        elif self.plan.training:
            self.grad_ready[sid][mb].succeed()  # loss is computed locally

    def _run_bd(self, sid: int, mb: int, pending_dp: List) -> Generator:
        stage = self.mapped.stages[sid]
        env = self.env
        t_enter = env.now
        yield self.grad_ready[sid][mb]
        t_ready = env.now
        res, req = self._acquire_compute(sid, priority=0)   # BD first (1F1B)
        if req is not None:
            yield req
        start = env.now
        if res is not None and start > t_ready:
            pred = self._last_res_row.get(tuple(stage.devices), -1)
        elif t_ready > t_enter:
            pred = (self._row_idx.get((sid, KIND_FD, mb), -1)
                    if sid == self.mapped.num_stages - 1
                    else self._row_idx.get((sid + 1, KIND_BD, mb), -1))
        else:
            pred = self._prev_row[sid]
        for split, acc in zip(reversed(stage.split_ops), reversed(self.access[sid])):
            compute = self._compute_time(split.bwd_flops_tile, split.matmul_fraction)
            if self.recompute:  # Fig. 5 Recompute sub-process
                compute += self._compute_time(split.fwd_flops_tile,
                                              split.matmul_fraction)
            yield from self._dram_and_compute(stage, acc.bd_act, acc.bd_weight,
                                              compute)
            yield from self._stage_collectives(stage, split.comms, BD, priority=1)
            if mb == self.plan.num_microbatches - 1:
                # DP gradient sync: async, overlaps later compute (Fig. 5)
                pending_dp.append(env.process(
                    self._stage_collectives(stage, split.comms, GU, priority=2)))
        row = self.recorder.compute(sid, KIND_BD, mb, start, env.now, pred)
        self._row_idx[(sid, KIND_BD, mb)] = row
        self._prev_row[sid] = row
        if res is not None:
            self._last_res_row[tuple(stage.devices)] = row
            res.release(req)
        if sid > 0:
            yield from self._boundary_pass(sid, sid - 1, mb, kind="grad")
            self.grad_ready[sid - 1][mb].succeed()

    def _run_gu(self, sid: int, pending_dp: List) -> Generator:
        stage = self.mapped.stages[sid]
        env = self.env
        t_enter = env.now
        if pending_dp:
            yield env.all_of(pending_dp)
        start = env.now
        pred = (self._row_idx.get(
                    (sid, KIND_BD, self.plan.num_microbatches - 1), -1)
                if start > t_enter else self._prev_row[sid])
        gu_bytes = sum(a.gu_bytes for a in self.access[sid])
        if gu_bytes > 0:
            # full-precision weight load from DRAM and store back (§IV-A);
            # optimizer state is per-shard (not replicated across DP)
            yield env.process(self.dram.group_access(
                stage.devices, 0.0, shared_bytes=gu_bytes / 2,
                num_shards=stage.weight_shards))
            yield env.process(self.dram.group_access(
                stage.devices, 0.0, write=True, shared_bytes=gu_bytes / 2,
                num_shards=stage.weight_shards))
        row = self.recorder.compute(sid, KIND_GU, 0, start, env.now, pred)
        self._row_idx[(sid, KIND_GU, 0)] = row
        self._prev_row[sid] = row
        self._gu_done[sid].succeed()

    def _boundary_pass(self, src: int, dst: int, mb: int, kind: str) -> Generator:
        """Act/Grad Pass between adjacent stages (NoC communication event)."""
        env = self.env
        s_from = self.mapped.stages[src]
        s_to = self.mapped.stages[dst]
        nbytes = self.mapped.boundary_elems(min(src, dst)) * self.hw.precision_bytes
        if self.boundary_mode == BoundaryMode.STRATEGY and len(s_from.devices) > 1:
            yield from self.noc.group_to_group(
                s_from.devices, s_to.devices, nbytes,
                strategy=self.plan.comm_strategy,
                num_adapters=max(1, len(s_to.devices) // 4))
            return
        # pairwise: rank i -> rank i (Megatron-style P2P), concurrent
        n = min(len(s_from.devices), len(s_to.devices))
        per = nbytes / n
        procs = [env.process(self.noc.transfer(s_from.devices[i], s_to.devices[i],
                                               per, priority=0))
                 for i in range(n)]
        yield env.all_of(procs)

    # -- per-stage worker (Prior Selector as deterministic work list) --------
    def _work_list(self, sid: int) -> List[Tuple[str, int]]:
        S, M = self.mapped.num_stages, self.plan.num_microbatches
        if not self.plan.training:
            return [(FD, i) for i in range(M)]
        if self.plan.schedule == Schedule.GPIPE:
            return [(FD, i) for i in range(M)] + [(BD, i) for i in range(M)]
        # 1F1B: warmup forwards, then strict BD-before-FD alternation
        w = min(S - sid, M)
        order: List[Tuple[str, int]] = [(FD, i) for i in range(w)]
        bd, fd = 0, w
        while bd < M:
            order.append((BD, bd)); bd += 1
            if fd < M:
                order.append((FD, fd)); fd += 1
        return order

    def _stage_proc(self, sid: int) -> Generator:
        pending_dp: List = []
        for kind, mb in self._work_list(sid):
            if kind == FD:
                yield from self._run_fd(sid, mb)
            else:
                yield from self._run_bd(sid, mb, pending_dp)
        if self.plan.training:
            yield from self._run_gu(sid, pending_dp)

    # -- entry ----------------------------------------------------------------
    def run(self) -> SimResult:
        """Simulate per the configured engine.

        ``event`` always runs the generator/heap kernel; ``auto`` tries the
        closed-form fast tier first (bit-identical when it applies) and
        silently falls back on static ineligibility or detected resource
        contention; ``fast`` demands the fast tier and raises
        :class:`~repro_torch.core.fastpath.FastPathIneligible` otherwise."""
        if self.engine != "event":
            from .fastpath import try_fast_run

            result = try_fast_run(self, strict=(self.engine == "fast"))
            if result is not None:
                return self._attach_metrics(result)
        return self._attach_metrics(self._run_event())

    def _attach_metrics(self, result: SimResult) -> SimResult:
        """Attach the repro_torch.obs metrics document when enabled (no-op —
        and no import — otherwise, so disabled runs pay nothing)."""
        if self.metrics:
            from ..obs.simmetrics import run_metrics

            result.metrics = run_metrics(self, result)
        return result

    def _setup_events(self) -> None:
        """Create the Act/Grad Pass mailboxes and GU-done latches the
        event kernel synchronizes on (deferred from ``__init__`` so
        fast-tier runs skip the O(S x M) Event construction)."""
        S = self.mapped.num_stages
        M = self.plan.num_microbatches
        self.act_ready = [
            [self.env.event(f"act[{s}][{i}]") for i in range(M)]
            for s in range(S)]
        self.grad_ready = [
            [self.env.event(f"grad[{s}][{i}]") for i in range(M)]
            for s in range(S)]
        for i in range(M):
            self.act_ready[0][i].succeed()  # stage 0 fetches its own data
        self._gu_done = [self.env.event(f"gu[{s}]") for s in range(S)]

    def _run_event(self) -> SimResult:
        env = self.env
        self._setup_events()
        procs = [env.process(self._stage_proc(s), name=f"stage{s}")
                 for s in range(self.mapped.num_stages)]
        env.run(until_event=env.all_of(procs))
        total = env.now
        # flush any still-open resource busy intervals into the trace
        self.noc.close_open_intervals(total)
        self.dram.close_open_intervals(total)

        M = self.plan.num_microbatches
        samples = self.plan.global_batch
        if self.plan.training:
            throughput = samples / total if total > 0 else 0.0
        else:
            # steady-state pipeline rate, drain/setup excluded (§V-A3)
            finishes = sorted(t for (s, i), t in self._fd_done_t.items()
                              if s == self.mapped.num_stages - 1)
            mb_size = samples / M
            if len(finishes) > 1:
                throughput = (len(finishes) - 1) * mb_size / (finishes[-1] - finishes[0])
            else:
                throughput = samples / total if total > 0 else 0.0
        return SimResult(
            total_time=total,
            throughput=throughput,
            stage_memory=self.memory,
            recompute=self.recompute,
            event_count=env.event_count,
            noc_bytes=self.noc.bytes_moved,
            dram_bytes=self.dram.bytes_accessed,
            trace=self.recorder.freeze(total, self.mapped.num_stages),
            noc_occupancy_fallback=(self.noc.occupancy_report()
                                    if not self.collect_timeline
                                    and self.noc._links else {}),
        )
