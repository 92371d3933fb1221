"""PALM as the framework's auto-parallelism (and hardware co-design) planner.

This is the paper's use-case made first-class: given an architecture
config and a hardware spec, sweep parallelism strategies through the
event-driven simulator (the §V-B loop: "directly iterate parallelism
strategies based on simulation results") and emit the best plan. The
launchers consume the result to pick TP/DP/PP degrees, microbatch count,
stage layout and comm strategy.

With a :class:`repro_torch.api.HardwareSearchSpace` in :class:`PlannerCfg`, the
planner runs the paper's §VI loop instead: hardware variants and
parallelism plans are ranked *jointly* (one shared-pool sweep over the
flattened hardware x plan product) and :func:`plan_codesign` emits a
co-design recommendation — the best hardware spec (as serializable
:class:`HardwareSpec` JSON) together with the best plan on it.

Since the Experiment API landed this is a thin typed wrapper over
:class:`repro_torch.api.Experiment` + :class:`repro_torch.api.SweepEngine`: plan
enumeration lives in :class:`repro_torch.api.SearchSpace`, evaluation in the
(optionally process-parallel) sweep engine, and results come back as
ranked :class:`repro_torch.api.RunReport` objects (``.plan`` is the typed
ParallelPlan, ``.throughput`` the simulated rate).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, TYPE_CHECKING, Union

from ..configs.base import ArchConfig
from .enums import Layout, NoCMode, Schedule
from .hardware import HardwareSpec, tpu_v5e_pod

if TYPE_CHECKING:                       # api builds on core; keep it lazy
    from ..api import HardwareSearchSpace, RunReport, SweepReport
    from ..api.sweep import SweepEngine
    from ..serving.system import ServingSpec
    from .parallelism import ParallelPlan

__all__ = ["PlannerCfg", "CodesignResult", "plan_parallelism", "plan_codesign"]


@dataclass
class PlannerCfg:
    global_batch: int = 256
    seq_len: int = 4096
    training: bool = True
    schedules: Sequence[Union[Schedule, str]] = (Schedule.ONE_F_ONE_B,)
    layouts: Sequence[Union[Layout, str]] = (Layout.S_SHAPE, Layout.LINE)
    microbatch_sizes: Sequence[int] = (1, 2, 4)
    max_plans: int = 64
    memory_cap: Optional[float] = None     # bytes per tile
    noc_mode: Union[NoCMode, str] = NoCMode.MACRO
    workers: int = 0                       # 0 = serial; N = process pool
    # co-design: cross the plan sweep with hardware variants (§VI); the
    # merged ranking scores joint (hardware, plan) candidates through one
    # shared-pool sweep
    hardware_search: Optional["HardwareSearchSpace"] = None
    # "exhaustive" evaluates the full product; guided search ("random" /
    # "sh" / "evolve", the reference's repro.search) is the port's next
    # slice and raises NotImplementedError
    search_strategy: str = "exhaustive"
    search_budget: Optional[int] = None
    search_seed: Optional[int] = None      # guided strategies only; 0 default
    # SLO-aware serving objective: with objective="slo" candidates are
    # scored by SLO goodput under this traffic spec (the traffic-driven
    # serving simulator) instead of one training-iteration step time
    slo: Optional["ServingSpec"] = None


@dataclass
class CodesignResult:
    """Joint hardware/parallelism recommendation (§VI co-design loop).

    ``hardware`` is the winning variant as a full serializable spec —
    ``hardware.to_json()`` is ``--hardware-json`` compatible — and
    ``plan`` the best parallel plan on it; ``report`` keeps the whole
    ranked hardware x plan sweep for inspection.
    """

    hardware: HardwareSpec
    plan: "ParallelPlan"
    run: "RunReport"
    report: "SweepReport" = field(repr=False)
    objective: str = "throughput"        # "throughput" | "slo"

    @property
    def throughput(self) -> float:
        return self.run.throughput

    def to_dict(self) -> Dict[str, Any]:
        from ..api.report import plan_to_dict
        return {
            "hardware": self.hardware.to_dict(),
            "plan": plan_to_dict(self.plan),
            "objective": self.objective,
            "throughput": self.run.throughput,
            "total_time": self.run.total_time,
            "bubble_ratio": self.run.bubble_ratio,
            "peak_memory_bytes": self.run.peak_memory_bytes,
            "num_hardware": self.report.num_hardware,
            "num_candidates": self.report.num_candidates,
        }

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    def summary(self) -> str:
        p = self.plan
        unit = ("req/s SLO goodput" if self.objective == "slo"
                else "samples/s")
        return (f"{self.hardware.name}: pp={p.pp} dp={p.dp} tp={p.tp} "
                f"mb={p.microbatch} {p.schedule}/{p.layout} -> "
                f"{self.run.throughput:.2f} {unit}")


def _resolve_objective(cfg: PlannerCfg, objective: str) -> Optional["ServingSpec"]:
    """Validate the scoring objective; returns the ServingSpec for "slo"."""
    if objective == "throughput":
        return None
    if objective != "slo":
        raise ValueError(f"unknown objective {objective!r}; "
                         "known: throughput, slo")
    from ..serving.system import ServingSpec    # the simulation half
    return cfg.slo if cfg.slo is not None else ServingSpec()


def _make_experiment(arch: ArchConfig, hardware: Optional[HardwareSpec],
                     cfg: PlannerCfg,
                     serving: Optional["ServingSpec"] = None):
    from ..api import Experiment, SearchSpace   # api builds on core

    hardware = hardware or tpu_v5e_pod()
    if serving is not None:
        # SLO objective: score candidates on decode traffic — the plan's
        # own batch is resized per engine step by the StepCostModel, so
        # global_batch only gates which dp splits enumerate
        return Experiment(
            arch=arch,
            hardware=hardware,
            search=SearchSpace(
                layouts=tuple(cfg.layouts),
                microbatch_sizes=(1,),
                max_plans=cfg.max_plans,
            ),
            hardware_search=cfg.hardware_search,
            seq_len=cfg.seq_len,
            global_batch=serving.max_batch,
            training=False,
            decode=True,
            noc_mode=cfg.noc_mode,
            memory_cap=cfg.memory_cap,
            serving=serving,
        )
    return Experiment(
        arch=arch,
        hardware=hardware,
        search=SearchSpace(
            schedules=tuple(cfg.schedules),
            layouts=tuple(cfg.layouts),
            microbatch_sizes=tuple(cfg.microbatch_sizes),
            max_plans=cfg.max_plans,
        ),
        hardware_search=cfg.hardware_search,
        seq_len=cfg.seq_len,
        global_batch=cfg.global_batch,
        training=cfg.training,
        noc_mode=cfg.noc_mode,
        memory_cap=cfg.memory_cap,
    )


def _sweep_kwargs(cfg: PlannerCfg, strategy: Optional[str]) -> Dict[str, Any]:
    strategy = strategy or cfg.search_strategy
    kw: Dict[str, Any] = {"workers": cfg.workers}
    if strategy not in (None, "exhaustive"):
        from ..api.report import refuse_search  # api builds on core
        refuse_search(f"search strategy {strategy!r}")
    elif cfg.search_budget is not None or cfg.search_seed is not None:
        raise ValueError("PlannerCfg.search_budget/search_seed only apply "
                         "to guided search; set search_strategy to "
                         "'random'/'sh'/'evolve'")
    return kw


def plan_parallelism(
    arch: ArchConfig,
    hardware: Optional[HardwareSpec] = None,
    cfg: PlannerCfg = PlannerCfg(),
    strategy: Optional[str] = None,
    objective: str = "throughput",
    engine: Optional["SweepEngine"] = None,
):
    """Sweep (pp, dp, tp, microbatch, layout, schedule) and rank by
    simulated throughput. Returns sorted RunReports (best first).

    With ``cfg.hardware_search`` set, hardware variants derived from
    ``hardware`` are swept jointly with the plans (one shared process
    pool) and the ranking covers (hardware, plan) pairs — each report's
    ``.hardware`` names the variant. Use :func:`plan_codesign` to get the
    winning variant back as a full :class:`HardwareSpec`.

    ``strategy`` (or ``cfg.search_strategy``) other than ``"exhaustive"``
    raises: guided search is the port's next slice.

    ``objective="slo"`` ranks candidates by SLO goodput under the traffic
    spec in ``cfg.slo`` (the serving simulator) instead of training step
    throughput; each report's full :class:`ServingReport` dict rides in
    ``.extra["serving"]``. ``engine`` lends an open persistent
    :class:`SweepEngine` whose warm pool is reused (never closed here);
    by default the module-level :func:`repro_torch.api.sweep.shared_engine`
    pool is used, so back-to-back planner calls about the same
    experiment re-initialize nothing. The planner's experiments run the
    event engine, so no job reaches the batched tier or the card: the
    planner is host code, as ``simulate_serving`` is, and its engine is a
    host one (``device="cpu"``), which runs without a card.
    """
    exp = _make_experiment(arch, hardware, cfg,
                           serving=_resolve_objective(cfg, objective))
    if engine is None:
        from ..api.sweep import shared_engine   # api builds on core
        engine = shared_engine(workers=cfg.workers, device="cpu")
    return exp.sweep(engine=engine, **_sweep_kwargs(cfg, strategy)).runs


def plan_codesign(
    arch: ArchConfig,
    hardware: Optional[HardwareSpec] = None,
    cfg: PlannerCfg = PlannerCfg(),
    strategy: Optional[str] = None,
    objective: str = "throughput",
    engine: Optional["SweepEngine"] = None,
) -> CodesignResult:
    """Joint hardware/parallelism co-design (§VI): rank the flattened
    (hardware variant x plan) product and return the best pair as a
    :class:`CodesignResult` (winning spec + plan + full ranked report).

    ``cfg.hardware_search`` must be set — with no hardware axes there is
    nothing to co-design and :func:`plan_parallelism` is the right call.
    ``strategy`` (or ``cfg.search_strategy``) other than ``"exhaustive"``
    raises: guided search is the port's next slice.

    ``objective="slo"`` co-designs for *serving*: every (hardware, plan)
    pair is scored by SLO goodput under ``cfg.slo`` traffic, so a machine
    that wins on training step time can lose to one with the bandwidth
    headroom decode traffic actually needs. ``engine`` lends an open
    persistent :class:`SweepEngine` (reused, never closed here); defaults
    to the module-level :func:`repro_torch.api.sweep.shared_engine` pool,
    a host one, as in :func:`plan_parallelism`.
    """
    if cfg.hardware_search is None:
        raise ValueError("plan_codesign needs cfg.hardware_search (use "
                         "plan_parallelism for a parallelism-only sweep)")
    exp = _make_experiment(arch, hardware, cfg,
                           serving=_resolve_objective(cfg, objective))
    if engine is None:
        from ..api.sweep import shared_engine   # api builds on core
        engine = shared_engine(workers=cfg.workers, device="cpu")
    report = exp.sweep(engine=engine, **_sweep_kwargs(cfg, strategy))
    best = report.best
    if best is None:
        raise RuntimeError(
            f"no feasible (hardware, plan) candidate for {exp.arch_name}: "
            f"{report.num_candidates} candidates, "
            f"{report.num_pruned_memory} memory-pruned, "
            f"{report.num_failed} failed")
    spec_dict = report.best_hardware_dict()
    if spec_dict is not None:
        spec = HardwareSpec.from_dict(spec_dict)
    elif best.hardware == exp.hardware_spec.name:
        spec = exp.hardware_spec          # winner is the unmodified base
    else:
        # never hand back a base spec that contradicts the winning run
        raise RuntimeError(
            f"winning variant {best.hardware!r} has no serializable "
            "HardwareSpec (custom topology without a declarative spec); "
            "build the base hardware from a TopologySpec to co-design")
    return CodesignResult(hardware=spec, plan=best.plan, run=best,
                          report=report, objective=objective)
