"""PALM top-level entry points (Fig. 2).

``simulate`` runs one training iteration (or an inference pipeline) of a
computation graph on a hardware spec under a parallelism plan and returns
absolute performance. ``sweep_plans`` is the planner loop the paper uses
in §V-B: iterate parallelism strategies directly against simulation
results — the capability the paper says existing simulators lack.

These remain the low-level functional entry points;
:mod:`repro_torch.api` wraps them in the declarative
:class:`~repro_torch.api.Experiment` / :class:`~repro_torch.api.SweepEngine`
surface (typed enums, process-pool sweeps, JSON reports) which is the
canonical front door.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

from .enums import BoundaryMode, NoCMode
from .graph import ComputationGraph
from .hardware import HardwareSpec
from .parallelism import MappedGraph, ParallelPlan, map_graph, plan_sort_key
from .scheduler import (
    PipelineSimulator,
    SimResult,
    ideal_pipeline_time,
    plan_memory,
)

__all__ = ["simulate", "sweep_plans", "PlanResult"]


def simulate(
    graph: ComputationGraph,
    hardware: HardwareSpec,
    plan: ParallelPlan,
    noc_mode: NoCMode = NoCMode.MACRO,
    collect_timeline: bool = False,
    boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE,
    engine: str = "event",
) -> SimResult:
    """Run PALM once. ``graph`` must be built with per-iteration batch
    ``plan.microbatch * plan.dp`` (the DP group's micro-batch).

    The result's columnar ``trace`` always carries the FD/BD/GU compute
    lanes; ``collect_timeline=True`` additionally records NoC-link and
    DRAM-channel busy intervals (resource lanes).

    ``engine`` selects the simulator tier: ``"event"`` (the generator/
    heap kernel), ``"auto"`` (try the bit-identical closed-form fast
    tier, fall back on contention) or ``"fast"`` (fast tier or raise) —
    see :mod:`repro_torch.core.fastpath`."""
    noc_mode = NoCMode(noc_mode)
    boundary_mode = BoundaryMode(boundary_mode)
    mapped = map_graph(graph, hardware, plan)
    sim = PipelineSimulator(mapped, noc_mode=noc_mode,
                            collect_timeline=collect_timeline,
                            boundary_mode=boundary_mode,
                            engine=engine)
    return sim.run()


@dataclass
class PlanResult:
    plan: ParallelPlan
    result: SimResult

    @property
    def throughput(self) -> float:
        return self.result.throughput


def sweep_plans(
    graph_builder: Callable[[ParallelPlan], ComputationGraph],
    hardware: HardwareSpec,
    plans: Iterable[ParallelPlan],
    noc_mode: NoCMode = NoCMode.MACRO,
    memory_cap: Optional[float] = None,
    engine: str = "event",
) -> List[PlanResult]:
    """Evaluate many parallelism strategies; returns results sorted by
    throughput (best first). Plans whose per-tile footprint exceeds
    ``memory_cap`` are dropped (the paper's capacity feasibility check)
    *before* simulation: the footprint is a property of the mapped graph,
    so infeasible plans cost a mapping, not a full event-driven run."""
    noc_mode = NoCMode(noc_mode)
    out: List[PlanResult] = []
    for plan in plans:
        graph = graph_builder(plan)
        mapped = map_graph(graph, hardware, plan)
        mem_plan = None
        if memory_cap is not None:
            mem_plan = plan_memory(mapped)
            if max(m.total for m in mem_plan[0]) > memory_cap:
                continue
        sim = PipelineSimulator(mapped, noc_mode=noc_mode, memory_plan=mem_plan,
                                engine=engine)
        out.append(PlanResult(plan=plan, result=sim.run()))
    # tie-break equal-throughput plans canonically so this ranking and the
    # SweepEngine's (run_rank_key) compare exactly on one hardware spec
    out.sort(key=lambda r: (-r.throughput, plan_sort_key(r.plan)))
    return out
