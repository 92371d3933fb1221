"""Unified Experiment API — the canonical front door to the PALM simulator.

One typed entry point for the three workflows the repo exposes:

* **simulate** — ``Experiment(arch=..., plan=ParallelPlan(...)).run()``
* **sweep**    — ``Experiment(arch=..., search=SearchSpace(...)).sweep()``,
  optionally crossed with a :class:`HardwareSearchSpace` to rank
  hardware x parallelism points (the paper's §VI exploration)
* **plan**     — :func:`repro_torch.core.planner.plan_parallelism` (built on the
  same engine), or ``python -m repro_torch plan`` from the shell.

Configuration is fully typed: enums (:class:`Schedule`, :class:`Layout`,
:class:`NoCMode`, :class:`BoundaryMode`) for modes, declarative
serializable :class:`HardwareSpec` for machines (presets are data —
dump one with ``python -m repro_torch hardware``, tweak the JSON, load it with
``--hardware-json``). Results come back as JSON-round-trip
:class:`RunReport` / :class:`SweepReport` dataclasses.
"""

from ..core.enums import BoundaryMode, Layout, NoCMode, Schedule
from ..core.hardware import (
    GPUClusterSpec,
    HardwareSpec,
    HierarchicalSpec,
    MeshSpec,
    TopologySpec,
)
from ..core.parallelism import ParallelPlan
from ..core.trace import Trace, TraceDiff, TraceRecorder, chrome_trace
from ..core.trace import diff as trace_diff
from ..core.planner import (
    CodesignResult,
    PlannerCfg,
    plan_codesign,
    plan_parallelism,
)
from .experiment import (
    Experiment,
    HARDWARE_PRESETS,
    HardwareSearchSpace,
    SearchSpace,
    resolve_hardware,
)
from .report import (
    RunReport,
    SweepReport,
    plan_from_dict,
    plan_to_dict,
    run_rank_key,
)
from .sweep import SweepEngine, close_shared_engines, shared_engine

__all__ = [
    "BoundaryMode",
    "CodesignResult",
    "Experiment",
    "GPUClusterSpec",
    "HARDWARE_PRESETS",
    "HardwareSearchSpace",
    "HardwareSpec",
    "HierarchicalSpec",
    "Layout",
    "MeshSpec",
    "NoCMode",
    "ParallelPlan",
    "PlannerCfg",
    "RunReport",
    "Schedule",
    "SearchSpace",
    "SweepEngine",
    "SweepReport",
    "TopologySpec",
    "Trace",
    "TraceDiff",
    "TraceRecorder",
    "chrome_trace",
    "close_shared_engines",
    "trace_diff",
    "plan_codesign",
    "plan_from_dict",
    "plan_parallelism",
    "plan_to_dict",
    "resolve_hardware",
    "run_rank_key",
    "shared_engine",
]
