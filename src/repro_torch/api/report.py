"""Structured results for the Experiment API.

A :class:`RunReport` is the digest of one simulation: the typed
:class:`ParallelPlan` that ran, where it ran, and the performance PALM
predicts. A :class:`SweepReport` is a ranked collection of RunReports
plus sweep accounting (how many plans were pruned before simulation and
why).

Both round-trip through ``to_json`` / ``from_json`` so benchmarks and
downstream tools can persist sweeps without pickling simulator objects;
plans serialize as plain dicts (:func:`plan_to_dict`).

A RunReport stays scalar by default: when a sweep runs with
``return_timelines=True`` the columnar :class:`~repro_torch.core.trace.Trace`
rides along in ``trace`` (and the full :class:`SimResult` in ``sim``),
both excluded from JSON and from equality so scalar reports and their
round-trips are unaffected. ``to_dict(include_trace=True)`` embeds the
trace's compact JSON-safe dict, and :meth:`RunReport.trace_summary`
digests it (per-stage utilization, bubble fraction, critical path,
resource occupancy) without shipping the event columns.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:                       # search builds on api; keep it lazy
    from ..search.report import SearchReport

from ..core.enums import Layout, Schedule
from ..core.parallelism import ParallelPlan, plan_sort_key
from ..core.scheduler import SimResult
from ..core.trace import Trace

__all__ = ["RunReport", "SweepReport", "plan_to_dict", "plan_from_dict",
           "run_rank_key"]

# ParallelPlan fields that are not JSON-scalar and rarely swept; they are
# serialized only when set so reports stay compact.
_PLAN_OPTIONAL = ("stage_binding", "tile_binding")


def plan_to_dict(plan: ParallelPlan) -> Dict[str, Any]:
    d = dataclasses.asdict(plan)
    d["schedule"] = str(plan.schedule)
    d["layout"] = str(plan.layout)
    for k in _PLAN_OPTIONAL:
        if d.get(k) is None:
            d.pop(k, None)
    return d


def plan_from_dict(d: Dict[str, Any]) -> ParallelPlan:
    kw = dict(d)
    kw["schedule"] = Schedule(kw.get("schedule", "1f1b"))
    kw["layout"] = Layout(kw.get("layout", "s_shape"))
    return ParallelPlan(**kw)


def run_rank_key(run: "RunReport"):
    """Total ranking order for sweep runs: throughput (best first) with a
    deterministic tie-break on the run's canonical (hardware, plan)
    identity. Ties on throughput are common — hardware axes that don't
    touch a bottleneck produce bit-equal results — and a plain
    ``-throughput`` sort would leave their order to job arrival, which
    differs between executors and between the batched and per-job fast
    tiers. Every ranking in the tree (sweep, search assembly, legacy
    ``sweep_plans``, benches) tie-breaks on the same
    :func:`~repro_torch.core.parallelism.plan_sort_key` so rankings compare
    exactly."""
    return (-run.throughput, run.hardware, plan_sort_key(run.plan))


@dataclass
class RunReport:
    """One simulated (plan, hardware, workload) point."""

    arch: str
    hardware: str
    plan: ParallelPlan
    total_time: float
    throughput: float
    bubble_ratio: float
    peak_memory_bytes: float
    recompute: bool
    event_count: int
    noc_bytes: float
    dram_bytes: float
    extra: Dict[str, Any] = field(default_factory=dict)
    # full SimResult when the sweep ran with return_timelines=True; never
    # part of JSON-by-default, never compared
    sim: Optional[SimResult] = field(default=None, compare=False, repr=False)
    # the columnar event timeline (same object the sim holds); shipped
    # across the process pool in compressed columnar form
    trace: Optional[Trace] = field(default=None, compare=False, repr=False)
    # repro_torch.obs metrics document ({"sim": ..., "host": ...}) when the run
    # recorded metrics; the sim half is deterministic, the host half is
    # not, so the field stays out of equality (JSON keeps it — it is
    # plain data and what `python -m repro_torch metrics` reads back)
    metrics: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                              repr=False)

    @classmethod
    def from_sim(cls, arch: str, hardware: str, plan: ParallelPlan,
                 result: SimResult, keep_sim: bool = False,
                 **extra: Any) -> "RunReport":
        # surface which simulator tier produced the numbers (fast tier is
        # bit-identical, so this is attribution, not a result qualifier)
        if getattr(result, "engine", "event") != "event":
            extra.setdefault("engine", result.engine)
        return cls(
            arch=arch,
            hardware=hardware,
            plan=plan,
            total_time=result.total_time,
            throughput=result.throughput,
            bubble_ratio=result.bubble_ratio,
            peak_memory_bytes=max((m.total for m in result.stage_memory),
                                  default=0.0),
            recompute=result.recompute,
            event_count=result.event_count,
            noc_bytes=result.noc_bytes,
            dram_bytes=result.dram_bytes,
            extra=dict(extra),
            sim=result if keep_sim else None,
            trace=result.trace if keep_sim else None,
            metrics=getattr(result, "metrics", None),
        )

    def trace_summary(self) -> Optional[Dict[str, Any]]:
        """JSON-safe analytics digest of the attached trace (None when the
        run carried no timeline)."""
        return None if self.trace is None else self.trace.summary()

    def to_dict(self, include_trace: bool = False) -> Dict[str, Any]:
        # drop sim/trace before asdict: event columns are not part of the
        # default JSON form, and deep-converting thousands of events just
        # to pop them is waste
        src = self
        if self.sim is not None or self.trace is not None:
            src = dataclasses.replace(self, sim=None, trace=None)
        d = dataclasses.asdict(src)
        d["plan"] = plan_to_dict(self.plan)
        d.pop("sim", None)
        d.pop("trace", None)
        if d.get("metrics") is None:
            d.pop("metrics", None)
        if include_trace and self.trace is not None:
            d["trace"] = self.trace.to_dict()
        return d

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunReport":
        d = dict(d)
        d["plan"] = plan_from_dict(d["plan"])
        d.pop("sim", None)
        trace = d.pop("trace", None)
        if trace is not None:
            d["trace"] = Trace.from_dict(trace)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunReport":
        return cls.from_dict(json.loads(s))

    def summary(self) -> str:
        p = self.plan
        return (f"pp={p.pp} dp={p.dp} tp={p.tp} mb={p.microbatch} "
                f"{p.schedule}/{p.layout} -> {self.throughput:.2f} samples/s, "
                f"bubble {self.bubble_ratio:.1%}, "
                f"peak mem {self.peak_memory_bytes / 1e9:.2f} GB")


@dataclass
class SweepReport:
    """Ranked sweep outcome (best plan first) + pruning accounting."""

    arch: str
    hardware: str
    runs: List[RunReport]                # sorted by throughput, best first
    num_candidates: int = 0              # plans enumerated
    num_pruned_memory: int = 0           # dropped by the pre-sim memory check
    num_failed: int = 0                  # raised during mapping/simulation
    executor: str = "serial"
    num_hardware: int = 1                # hardware variants swept (§VI search)
    # variant name -> HardwareSpec dict for hardware x plan sweeps, so the
    # winning machine is recoverable from the report alone (co-design)
    hardware_specs: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # representative per-outcome diagnostics (capped; counters above stay
    # exact): memory-pruned plans carry peak/cap/deficit bytes, failed
    # plans the raised error — so planners can say *why* nothing fit
    pruned_records: List[Dict[str, Any]] = field(default_factory=list)
    failed_records: List[Dict[str, Any]] = field(default_factory=list)
    # guided-search accounting (repro_torch.search): per-rung history, sims
    # per fidelity, best-so-far curve. None for exhaustive sweeps.
    search: Optional["SearchReport"] = None
    # per-phase timing/count accounting of the batched fast tier
    # (compile/batch-eval/validate/fallback microseconds plus job
    # counters) when the sweep ran with profiling on; timings vary run to
    # run, so the field is excluded from equality
    profile: Optional[Dict[str, Any]] = field(default=None, compare=False)
    # repro_torch.obs metrics document ({"sim": ..., "host": ...}): the sim half
    # aggregates compare=True run scalars in job order (bit-identical
    # across engine tiers and executors); the host half is the merged
    # registry of the parent process and every pool shard
    metrics: Optional[Dict[str, Any]] = field(default=None, compare=False)

    @property
    def best(self) -> Optional[RunReport]:
        return self.runs[0] if self.runs else None

    def best_hardware_dict(self) -> Optional[Dict[str, Any]]:
        """HardwareSpec dict of the best run's variant (None when the sweep
        had no hardware search or the variant spec was not serializable)."""
        if self.best is None:
            return None
        return self.hardware_specs.get(self.best.hardware)

    def to_dict(self) -> Dict[str, Any]:
        # leave runs (their sims could be huge) and the typed search report
        # out of the asdict recursion; both serialize themselves
        d = dataclasses.asdict(dataclasses.replace(self, runs=[], search=None))
        d["runs"] = [r.to_dict() for r in self.runs]
        if self.search is not None:
            d["search"] = self.search.to_dict()
        else:
            d.pop("search", None)
        if self.profile is None:
            d.pop("profile", None)
        if self.metrics is None:
            d.pop("metrics", None)
        return d

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepReport":
        d = dict(d)
        d["runs"] = [RunReport.from_dict(r) for r in d.get("runs", [])]
        search = d.pop("search", None)
        if search is not None:
            from ..search.report import SearchReport
            d["search"] = SearchReport.from_dict(search)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SweepReport":
        return cls.from_dict(json.loads(s))

    def table(self, top: int = 10) -> str:
        # hardware column only for hardware x parallelism sweeps
        hw_col = self.num_hardware > 1
        width = max([len("hardware")] +
                    [len(r.hardware) for r in self.runs[:top]]) if hw_col else 0
        head = f"{'hardware':>{width}s} " if hw_col else ""
        lines = [f"{head}{'pp':>3s} {'dp':>3s} {'tp':>3s} {'mb':>3s} "
                 f"{'schedule':>8s} {'layout':>8s} {'samples/s':>10s} "
                 f"{'bubble':>7s} {'mem GB':>7s}"]
        for r in self.runs[:top]:
            p = r.plan
            prefix = f"{r.hardware:>{width}s} " if hw_col else ""
            lines.append(
                f"{prefix}{p.pp:3d} {p.dp:3d} {p.tp:3d} {p.microbatch:3d} "
                f"{str(p.schedule):>8s} {str(p.layout):>8s} {r.throughput:10.3f} "
                f"{r.bubble_ratio:7.1%} {r.peak_memory_bytes / 1e9:7.2f}")
        return "\n".join(lines)
