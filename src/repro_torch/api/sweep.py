"""Parallel sweep engine for Experiment plan and hardware x plan searches.

Executes sweeps through a ``concurrent.futures`` process pool (or
serially with ``workers=0``) with four structural optimizations over the
legacy ``sweep_plans`` loop:

* **Graph-construction memoization** — the workload graph depends only on
  the per-iteration batch (``microbatch * dp``), not the full plan or the
  hardware, so plans sharing a batch share one graph build per process
  (across hardware variants too).
* **Early infeasibility pruning** — per-tile memory is a property of the
  *mapped* graph, so the ``memory_cap`` check runs before the event-driven
  simulation and infeasible plans cost a mapping, not a full run.
* **One shared pool for hardware sweeps** — a hardware x plan sweep is a
  single flat job stream of ``(variant, plan)`` pairs evaluated by one
  process pool whose workers are initialized once with the pickled
  experiment and every variant spec, instead of spawning a fresh pool per
  hardware variant (see ``benchmarks/bench_sweep_engine.py`` for the
  speedup over the pool-per-variant baseline).
* **Batched fast tier** — fast-path-eligible jobs (``engine`` ``"auto"``
  or ``"fast"``) are collected and priced through
  :func:`repro_torch.core.fastbatch.run_fast_batch`, which groups
  configurations by chain *shape signature* and replays whole groups on
  the engine's ``device`` (the ``chain_replay`` kernel on the card, its
  plain version on the CPU) instead of one Python chain walk per job.
  Results are bit-identical to the per-job tiers; jobs the batch rejects
  (contention, ineligibility) fall back to the per-job path one at a
  time. Only an error of the batch's host compile re-runs its jobs one
  at a time; a refusal of the kernel, a failed launch or an error of the
  device replay is raised, never re-run on the host. Workers receive contiguous job *shards* so each
  worker batches its share instead of evaluating job-at-a-time streams.

The batched tier is the only device work of a sweep: the graph build,
mapping, memory pruning, the event tier and the serving simulator are
host code. ``device=None`` means the card, and an engine raises at
construction without one; ``device="cpu"`` asks for the host.

Pools are ``spawn``-started: a forked child cannot use its parent's CUDA
context, and torch makes every process multi-threaded before a fork.
Each worker re-imports the port and, on the card, opens a CUDA context
of its own (seconds and some hundreds of MiB of device memory a
worker; ``workers=None`` opens one a CPU core). The parent builds the
kernel library before the pool starts, so workers load it and never
run ``nvcc``.

``return_timelines=True`` ships each run's event timeline back attached
to ``RunReport.trace`` (and the full :class:`SimResult` to ``.sim``).
The timeline crosses the pool in *columnar* form: :class:`Trace` pickles
through its compressed struct-of-arrays wire format
(``Trace.to_bytes``), which is several times smaller than the legacy
tuple-list ``SimResult`` payload (measured in
``benchmarks/bench_sweep_engine.py``). Reports stay scalar (and JSON
stays compact) by default.

Results are deterministic: the engine evaluates jobs in enumeration
order and ranks by :func:`~repro_torch.api.report.run_rank_key` (throughput,
then canonical hardware/plan identity), so serial, process-pool and
batched sweeps produce identical SweepReports.

:func:`shared_engine` hands out module-level *persistent* engines (one
per flag combination) whose process pools and memos stay warm across
planner calls — ``plan_parallelism`` / ``plan_codesign`` /
``plan_serving`` and the CLI all reuse them, so back-to-back planning
questions about the same experiment stop re-pickling and re-classifying
from scratch.
"""

from __future__ import annotations

import atexit
import dataclasses
import multiprocessing
import os
import pickle
import warnings
from concurrent.futures import ProcessPoolExecutor
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resolve_device
from ..core.enums import NoCMode
from ..core.fastbatch import BatchCompileError, run_fast_batch
from ..core.fastpath import reason_code
from ..core.hardware import HardwareSpec
from ..core.parallelism import ParallelPlan, map_graph
from ..core.scheduler import PipelineSimulator, plan_memory
from ..obs.registry import NULL_REGISTRY, make_registry
from ..core.trace import (
    KIND_BD,
    KIND_CODES,
    KIND_DRAM,
    KIND_FABRIC,
    KIND_FD,
    KIND_GU,
    KIND_NAMES,
    KIND_NOC,
)
from .report import RunReport, SweepReport, run_rank_key

__all__ = ["SweepEngine", "run_one", "shared_engine", "close_shared_engines"]

# outcome tags for one plan evaluation
_OK, _PRUNED, _FAILED = "ok", "pruned", "failed"

# a job is (hardware-variant index, plan) — or (variant, plan, fidelity)
# where fidelity is a reduced-cost evaluation knob (see
# the reference's ``repro.search.Fidelity``, the port's next slice): anything
# with ``apply(plan)`` and a
# ``noc_mode`` attribute. Plain plan sweeps use variant index 0.
Job = Tuple[int, ParallelPlan]

# lane-drop priority when a trace payload budget is exceeded: resource
# lanes go first, FD/BD last (they carry the pipeline structure)
_LANE_DROP_ORDER = (KIND_FABRIC, KIND_DRAM, KIND_NOC, KIND_GU, KIND_BD, KIND_FD)

# cap on per-outcome diagnostic records kept in a SweepReport (counters
# stay exact; records exist so planners can explain representative
# failures, not to mirror the whole job stream)
_MAX_RECORDS = 128


def _plan_summary(plan: ParallelPlan) -> Dict:
    """Compact identity of a plan for pruned/failed diagnostics."""
    return {"pp": plan.pp, "dp": plan.dp, "tp": plan.tp,
            "microbatch": plan.microbatch}


def _lane_codes(lanes) -> Optional[Tuple[int, ...]]:
    """Normalize a lane filter (names or kind codes) to sorted codes."""
    if lanes is None:
        return None
    out = set()
    for lane in lanes:
        if isinstance(lane, str):
            if lane.upper() not in KIND_CODES:
                raise ValueError(f"unknown trace lane {lane!r}; known: "
                                 f"{', '.join(KIND_NAMES)}")
            out.add(KIND_CODES[lane.upper()])
        else:
            if not 0 <= int(lane) < len(KIND_NAMES):
                raise ValueError(f"unknown trace lane code {lane!r}")
            out.add(int(lane))
    return tuple(sorted(out))


def _apply_trace_policy(report: RunReport,
                        lanes: Optional[Tuple[int, ...]],
                        budget: Optional[int]) -> RunReport:
    """Lane-filter (and budget-bound) the trace a run ships back through
    the pool. Scalar digests were extracted before this runs, so reports
    keep exact bubble/occupancy numbers whatever lanes survive."""
    trace = report.trace
    if trace is None or (lanes is None and budget is None):
        return report
    present = {int(k) for k in trace.kind}
    keep = set(lanes) if lanes is not None else set(range(len(KIND_NAMES)))
    filtered = trace
    if lanes is not None and not present <= keep:
        filtered = trace.filter(kinds=sorted(keep))
    dropped: List[str] = []
    if budget is not None:
        for kind in _LANE_DROP_ORDER:
            if filtered.nbytes <= budget:
                break
            if kind in keep and kind in present:
                keep.discard(kind)
                dropped.append(KIND_NAMES[kind])
                filtered = filtered.filter(kinds=sorted(keep))
    if filtered is trace:
        return report
    report.trace = filtered
    if report.sim is not None:
        report.sim = dataclasses.replace(report.sim, trace=filtered)
    if dropped:
        report.extra["trace_lanes_dropped"] = dropped
    return report


def _prepare(exp, plan: ParallelPlan, graph_cache: Dict, hw: HardwareSpec,
             return_timelines: bool = False,
             trace_resources: bool = False,
             fidelity=None,
             trace_lanes: Optional[Tuple[int, ...]] = None,
             trace_budget_bytes: Optional[int] = None,
             registry=NULL_REGISTRY):
    """First half of one (hardware, plan) evaluation: resolve fidelity,
    build the (memoized) graph, map, prune on memory — and either settle
    the outcome without a pipeline run or hand back a constructed, unrun
    simulator.

    Returns ``("done", (tag, payload))`` when the job is decided here
    (serving jobs, memory-pruned jobs, mapping failures) or
    ``("sim", (sim, plan, engine))`` when a pipeline simulation remains.
    The split exists so :func:`_evaluate_many` can collect the
    simulators of a whole job stream and price them through the batched
    fast tier (:mod:`repro_torch.core.fastbatch`) instead of one at a time.

    ``fidelity`` optionally cheapens the simulation (coarser NoC model,
    fewer microbatches and/or a cheaper simulator tier) for
    multi-fidelity search rungs; the graph memo is unaffected because
    the per-iteration batch (``microbatch * dp``) does not change.

    Memory-pruned jobs carry a diagnostic payload (peak/cap/deficit
    bytes) so planners can explain *why* nothing was feasible instead of
    raising a bare error; :meth:`SweepEngine.sweep_jobs` merges it with
    the job's plan/hardware identity into ``SweepReport.pruned_records``.

    With ``exp.serving`` set (a :class:`repro_torch.serving.system.ServingSpec`)
    the job is scored by the traffic-driven serving simulator instead of
    one pipeline iteration: ``RunReport.throughput`` becomes the SLO
    *goodput* (requests meeting both SLOs per second), the full
    :class:`ServingReport` dict rides in ``extra["serving"]``, and the
    per-request trace ships back when timelines were requested. The
    pre-simulation memory pruning is unchanged."""
    try:
        noc_mode = exp.noc_mode
        engine = getattr(exp, "engine", "event")
        if fidelity is not None:
            resolve = getattr(fidelity, "resolve", None)
            if resolve is not None:
                plan, noc_mode, engine = resolve(plan, noc_mode, engine)
            else:   # duck-typed fidelity: apply() + optional knobs
                plan = fidelity.apply(plan)
                if fidelity.noc_mode is not None:
                    noc_mode = NoCMode(fidelity.noc_mode)
                if getattr(fidelity, "engine", None) is not None:
                    engine = fidelity.engine
        if exp.graph_builder is None:
            # arch_to_graph depends only on (arch, seq_len, batch, mode) —
            # never on the hardware — so the memo is shared across variants
            key = plan.microbatch * plan.dp
            graph = graph_cache.get(key)
            if graph is None:
                registry.counter("host.sweep.graph_memo.misses").inc()
                graph = exp.build_graph(plan)
                graph_cache[key] = graph
            else:
                registry.counter("host.sweep.graph_memo.hits").inc()
        else:
            graph = exp.build_graph(plan)   # builder may depend on full plan
        mapped = map_graph(graph, hw, plan)
        mem_plan = None
        if exp.memory_cap is not None:
            mem_plan = plan_memory(mapped)
            peak = max(m.total for m in mem_plan[0])
            if peak > exp.memory_cap:
                return ("done", (_PRUNED, {"peak_bytes": peak,
                                           "cap_bytes": exp.memory_cap,
                                           "deficit_bytes":
                                               peak - exp.memory_cap}))
        serving = getattr(exp, "serving", None)
        if serving is not None:
            from ..serving.system import ServingSimulator  # lazy: no cycle
            if fidelity is not None:
                serving = fidelity.apply_serving(serving)
            ssim = ServingSimulator(
                exp.arch_config, hw, plan, serving, noc_mode=noc_mode,
                boundary_mode=exp.boundary_mode,
                collect_trace=return_timelines or trace_resources,
                metrics=bool(getattr(exp, "metrics", False)))
            srep = ssim.run()
            report = RunReport(
                arch=exp.arch_name, hardware=hw.name, plan=plan,
                total_time=srep.sim_time, throughput=srep.goodput_rps,
                bubble_ratio=0.0,
                peak_memory_bytes=(max(m.total for m in mem_plan[0])
                                   if mem_plan is not None else 0.0),
                recompute=False,
                event_count=srep.steps.get("events", 0),
                noc_bytes=0.0, dram_bytes=0.0,
                extra={"serving": srep.to_dict()},
                trace=srep.trace if return_timelines else None,
                metrics=getattr(srep, "metrics", None))
            if return_timelines:
                report = _apply_trace_policy(report, trace_lanes,
                                             trace_budget_bytes)
            return ("done", (_OK, report))
        # compute lanes are always recorded; resource busy lanes stay off
        # unless the experiment asked for them (collect_timeline=True) so
        # default timeline sweeps keep pool payloads lean
        sim = PipelineSimulator(mapped, noc_mode=noc_mode,
                                boundary_mode=exp.boundary_mode,
                                memory_plan=mem_plan,
                                collect_timeline=trace_resources,
                                engine=engine,
                                metrics=bool(getattr(exp, "metrics", False)))
    except (ValueError, KeyError, TypeError) as e:
        return ("done", (_FAILED, f"{type(e).__name__}: {e}"))
    return ("sim", (sim, plan, engine))


def _finish(exp, plan: ParallelPlan, hw: HardwareSpec, result,
            return_timelines: bool,
            trace_lanes: Optional[Tuple[int, ...]],
            trace_budget_bytes: Optional[int]) -> Tuple[str, object]:
    """Second half of one evaluation: wrap a SimResult into the ranked
    RunReport (and apply the trace shipping policy)."""
    report = RunReport.from_sim(exp.arch_name, hw.name, plan, result,
                                keep_sim=return_timelines)
    if return_timelines:
        report = _apply_trace_policy(report, trace_lanes, trace_budget_bytes)
    return (_OK, report)


def _run_and_finish(exp, plan: ParallelPlan, hw: HardwareSpec, sim,
                    return_timelines: bool,
                    trace_lanes: Optional[Tuple[int, ...]],
                    trace_budget_bytes: Optional[int]) -> Tuple[str, object]:
    """Per-job simulation path (also the fallback for jobs the batched
    fast tier rejects): run the simulator's own tier dispatch and report.
    ``FastPathIneligible`` (engine="fast" strict mode) propagates."""
    try:
        result = sim.run()
        # the scalar occupancy digest is an in-process convenience; drop
        # it so serial and pooled sweeps return identical, lean results
        result.noc_occupancy_fallback.clear()
    except (ValueError, KeyError, TypeError) as e:
        return (_FAILED, f"{type(e).__name__}: {e}")
    return _finish(exp, plan, hw, result, return_timelines, trace_lanes,
                   trace_budget_bytes)


def _evaluate(exp, plan: ParallelPlan, graph_cache: Dict,
              hw: HardwareSpec,
              return_timelines: bool = False,
              trace_resources: bool = False,
              fidelity=None,
              trace_lanes: Optional[Tuple[int, ...]] = None,
              trace_budget_bytes: Optional[int] = None) -> Tuple[str, object]:
    """Evaluate one (hardware, plan) job: build (memoized) graph, map,
    prune on memory, simulate. Returns (tag, RunReport | reason).
    Composition of :func:`_prepare` and :func:`_run_and_finish`."""
    kind, payload = _prepare(exp, plan, graph_cache, hw,
                             return_timelines=return_timelines,
                             trace_resources=trace_resources,
                             fidelity=fidelity,
                             trace_lanes=trace_lanes,
                             trace_budget_bytes=trace_budget_bytes)
    if kind == "done":
        return payload
    sim, plan, _engine = payload
    return _run_and_finish(exp, plan, hw, sim, return_timelines,
                           trace_lanes, trace_budget_bytes)


def _evaluate_many(exp, specs: Sequence[HardwareSpec], jobs: Sequence,
                   graph_cache: Dict, *,
                   return_timelines: bool = False,
                   trace_resources: bool = False,
                   trace_lanes: Optional[Tuple[int, ...]] = None,
                   trace_budget_bytes: Optional[int] = None,
                   batch_fastpath: bool = True,
                   classify_memo: Optional[Dict] = None,
                   profile: Optional[Dict] = None,
                   registry=NULL_REGISTRY,
                   device=None) -> List[Tuple[str, object]]:
    """Evaluate a job stream with the batched fast tier on ``device``.

    Every job is prepared (graph/map/prune) in enumeration order; jobs
    whose engine admits the fast tier (``"auto"``/``"fast"``) are
    collected and priced together through
    :func:`repro_torch.core.fastbatch.run_fast_batch`, the rest run the
    per-job path inline. Batch-rejected jobs (contended, ineligible)
    fall back to the per-job path one at a time — for ``engine="auto"``
    that lands in the event kernel, for strict ``engine="fast"`` it
    re-raises ``FastPathIneligible`` exactly like the scalar tier.
    Outcomes come back in job order and are bitwise what the per-job
    loop would have produced. An error of the batch's host compile
    (:class:`~repro_torch.core.fastbatch.BatchCompileError`) re-runs the
    batch per job, as in the reference; every error from the group's
    program compile on (the device replay, ``chain_replay``'s refusals and
    launches) propagates."""
    outcomes: List = [None] * len(jobs)
    batch: List[Tuple[int, object, ParallelPlan, HardwareSpec]] = []
    for i, job in enumerate(jobs):
        variant, plan, fidelity = job if len(job) == 3 else (*job, None)
        hw = specs[variant]
        kind, payload = _prepare(exp, plan, graph_cache, hw,
                                 return_timelines=return_timelines,
                                 trace_resources=trace_resources,
                                 fidelity=fidelity,
                                 trace_lanes=trace_lanes,
                                 trace_budget_bytes=trace_budget_bytes,
                                 registry=registry)
        if kind == "done":
            outcomes[i] = payload
            continue
        sim, plan, engine = payload
        if batch_fastpath and engine in ("auto", "fast"):
            batch.append((i, sim, plan, hw))
        else:
            outcomes[i] = _run_and_finish(exp, plan, hw, sim,
                                          return_timelines, trace_lanes,
                                          trace_budget_bytes)
            reason = getattr(sim, "fastpath_reason", None)
            if reason is not None:
                registry.counter(
                    "host.fastpath.reject." + reason_code(reason)).inc()
    if batch:
        try:
            results = run_fast_batch([sim for _, sim, _, _ in batch],
                                     classify_memo=classify_memo,
                                     profile=profile, device=device)
        except BatchCompileError:
            # the host compile tripped on one config; re-run every job
            # through the per-job path, which scopes the error to the
            # config that raised it (exact scalar semantics)
            results = [(None, "batch compilation failed")] * len(batch)
        for (i, sim, plan, hw), (result, _reason) in zip(batch, results):
            if result is not None:
                if sim.metrics:
                    # the batched tier bypasses sim.run(), so attach the
                    # metrics document here (same derivation either way)
                    from ..obs.simmetrics import run_metrics
                    result.metrics = run_metrics(sim, result)
                outcomes[i] = _finish(exp, plan, hw, result,
                                      return_timelines, trace_lanes,
                                      trace_budget_bytes)
                continue
            # per-job retry: its own fast attempt re-derives the rejection
            # reason (or succeeds, e.g. after a batch compilation failure),
            # so the machine-readable cause reflects the final outcome
            t0 = perf_counter()
            outcomes[i] = _run_and_finish(exp, plan, hw, sim,
                                          return_timelines, trace_lanes,
                                          trace_budget_bytes)
            reason = getattr(sim, "fastpath_reason", None)
            if reason is not None:
                registry.counter(
                    "host.fastpath.reject." + reason_code(reason)).inc()
            if profile is not None:
                profile["fallback_us"] = (profile.get("fallback_us", 0)
                                          + int((perf_counter() - t0) * 1e6))
                profile["fallback_jobs"] = profile.get("fallback_jobs", 0) + 1
    if registry:
        registry.counter("host.sweep.jobs").inc(len(jobs))
        for outcome in outcomes:
            tag, payload = outcome
            if tag == _OK:
                registry.counter("host.sweep.engine."
                                 + payload.extra.get("engine", "event")).inc()
            elif tag == _PRUNED:
                registry.counter("host.sweep.pruned").inc()
            else:
                registry.counter("host.sweep.failed").inc()
    return outcomes


def run_one(exp, plan: ParallelPlan) -> RunReport:
    """Simulate one fixed plan (Experiment.run body)."""
    graph = exp.build_graph(plan)
    hw = exp.hardware_spec
    mapped = map_graph(graph, hw, plan)
    sim = PipelineSimulator(mapped, noc_mode=exp.noc_mode,
                            boundary_mode=exp.boundary_mode,
                            collect_timeline=exp.collect_timeline,
                            engine=getattr(exp, "engine", "event"),
                            metrics=bool(getattr(exp, "metrics", False)))
    return RunReport.from_sim(exp.arch_name, hw.name, plan, sim.run(),
                              keep_sim=exp.collect_timeline)


def _merge_profile(dst: Dict, src: Dict) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


def _shards(jobs: List, n: int) -> List[List]:
    """Split a job stream into <= n contiguous, near-equal shards (in
    order, no empties) so pooled workers batch their share of the stream
    instead of receiving it job-at-a-time."""
    n = max(1, min(n, len(jobs)))
    size, extra = divmod(len(jobs), n)
    out, i = [], 0
    for j in range(n):
        step = size + (1 if j < extra else 0)
        if step:
            out.append(jobs[i:i + step])
        i += step
    return out


# -- process-pool plumbing ---------------------------------------------------
# The Experiment and every hardware-variant spec are shipped once per
# worker (initializer) instead of once per task; each worker keeps its own
# per-variant graph memo and classifier memo across tasks.
_WORKER: Dict = {}


def _init_worker(exp_bytes: bytes, specs_bytes: bytes,
                 return_timelines: bool, trace_resources: bool,
                 trace_lanes: Optional[Tuple[int, ...]] = None,
                 trace_budget_bytes: Optional[int] = None,
                 batch_fastpath: bool = True,
                 device: str = "cuda") -> None:
    _WORKER["exp"] = pickle.loads(exp_bytes)
    _WORKER["specs"] = pickle.loads(specs_bytes)
    _WORKER["graphs"] = {}
    _WORKER["classify"] = {}
    _WORKER["return_timelines"] = return_timelines
    _WORKER["trace_resources"] = trace_resources
    _WORKER["trace_lanes"] = trace_lanes
    _WORKER["trace_budget_bytes"] = trace_budget_bytes
    _WORKER["batch_fastpath"] = batch_fastpath
    _WORKER["device"] = device


def _eval_shard_in_worker(shard) -> Tuple[List[Tuple[str, object]], Dict, Dict]:
    """Evaluate one contiguous job shard in a pool worker; returns the
    shard's outcomes plus its fast-tier profile delta and host-metrics
    registry document for merging in the parent."""
    exp = _WORKER["exp"]
    profile: Dict = {}
    registry = make_registry(bool(getattr(exp, "metrics", False)))
    with registry.span("host.pool.shard"):
        outcomes = _evaluate_many(
            exp, _WORKER["specs"], shard, _WORKER["graphs"],
            return_timelines=_WORKER["return_timelines"],
            trace_resources=_WORKER["trace_resources"],
            trace_lanes=_WORKER["trace_lanes"],
            trace_budget_bytes=_WORKER["trace_budget_bytes"],
            batch_fastpath=_WORKER["batch_fastpath"],
            classify_memo=_WORKER["classify"],
            profile=profile,
            registry=registry,
            device=_WORKER["device"])
    return outcomes, profile, registry.to_dict()


class SweepEngine:
    """Executes a plan sweep — or a merged hardware x plan sweep — for an
    Experiment.

    ``workers=0`` (default) runs serially in-process; ``workers=N`` uses an
    N-process pool; ``workers=None`` uses one process per CPU.
    ``return_timelines=True`` attaches each run's columnar event timeline
    to ``RunReport.trace`` (and the :class:`SimResult` to ``.sim``);
    timelines cross the pool in compressed columnar form.
    ``device`` is where the batched tier replays: ``None`` (the default)
    is the card and raises here without one, ``"cpu"`` the host. Pools
    are ``spawn``-started (module docstring: what a worker costs).
    ``trace_resources=True`` (``Experiment.collect_timeline``) further
    records NoC-link / DRAM-channel busy intervals into those traces —
    richer, but a bigger pool payload.

    ``trace_lanes`` restricts the lanes shipped back (names like
    ``("FD", "BD", "NOC")`` or kind codes), and ``trace_budget_bytes``
    bounds the worst-case per-run columnar payload: lanes are dropped
    in the fixed priority DRAM, NOC, GU, BD, FD until the trace fits
    (dropped lanes are recorded in ``RunReport.extra``). Report scalars
    (bubble ratio, occupancies) are computed *before* filtering, so they
    are exact regardless of what ships.

    ``batch_fastpath`` (default on) routes fast-tier-eligible jobs
    through the batched evaluator (:mod:`repro_torch.core.fastbatch`) —
    bit-identical results, one ``chain_replay`` launch per chain
    evaluation of a chain-shape group instead of one Python replay per
    job.
    ``profile=True`` attaches the per-phase accounting
    (compile/batch-eval/validate/fallback microseconds and job counters)
    of each call to its ``SweepReport.profile``; the cumulative totals
    are always kept on ``engine.profile_totals``.

    Used as a context manager the engine keeps one process pool alive
    across ``sweep``/``sweep_jobs``/``evaluate_jobs`` calls (workers stay
    warm across search generations); otherwise each call owns its pool.
    :func:`shared_engine` maintains module-level persistent engines for
    reuse across planner calls.
    """

    def __init__(self, workers: Optional[int] = 0,
                 return_timelines: bool = False,
                 trace_resources: bool = False,
                 trace_lanes: Optional[Sequence] = None,
                 trace_budget_bytes: Optional[int] = None,
                 batch_fastpath: bool = True,
                 profile: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.workers = os.cpu_count() if workers is None else workers
        self.return_timelines = return_timelines
        self.trace_resources = trace_resources
        self.trace_lanes = _lane_codes(trace_lanes)
        self.trace_budget_bytes = trace_budget_bytes
        self.batch_fastpath = batch_fastpath
        self.profile = profile
        # cumulative per-phase fast-tier accounting across calls; the
        # per-call delta lands on each SweepReport when profile=True
        self.profile_totals: Dict[str, int] = {}
        self.last_profile: Dict[str, int] = {}
        # merged host-domain registry document of the last evaluate_jobs
        # call (parent + every pool shard); None when the experiment did
        # not enable metrics
        self.last_metrics: Optional[Dict] = None
        self._persist = False
        self._pool: Optional[ProcessPoolExecutor] = None
        self._pool_key: Optional[Tuple[bytes, bytes]] = None
        # how many process pools this engine has created (tests assert a
        # persistent engine initializes exactly once across planner calls)
        self.pool_inits = 0
        # serial-path graph + classifier memos kept warm across calls in
        # persistent mode
        self._memo_exp = None
        self._memo_graphs: Dict = {}
        self._memo_classify: Dict = {}

    # -- persistent-pool lifecycle ------------------------------------------
    def __enter__(self) -> "SweepEngine":
        self._persist = True
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Shut the persistent pool down (no-op outside a with-block)."""
        self._shutdown_pool()
        self._persist = False
        self._memo_exp = None
        self._memo_graphs = {}
        self._memo_classify = {}

    def _serial_memo(self, exp) -> Tuple[Dict, Dict]:
        """(graph memo, classifier memo) for the serial path: per-call
        normally, kept warm across calls (per experiment) in persistent
        mode. Both are scoped to one experiment — classifier keys are
        (hardware name, plan summary), unique within an experiment's
        variants but not across experiments."""
        if not self._persist:
            return {}, {}
        if self._memo_exp is not exp:
            self._memo_exp = exp
            self._memo_graphs, self._memo_classify = {}, {}
        return self._memo_graphs, self._memo_classify

    def _new_pool(self, n: int, initargs: Tuple) -> ProcessPoolExecutor:
        """A ``spawn``-started pool of ``n`` workers. On the card the
        kernel library is built here first, so no worker runs nvcc."""
        if self.device.type == "cuda":
            from ..kernels import build
            build.library()
        return ProcessPoolExecutor(
            max_workers=n, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=initargs)

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
            self._pool_key = None

    def sweep(self, exp, plans: Sequence[ParallelPlan]) -> SweepReport:
        """Plan sweep on the experiment's single hardware spec."""
        hw = exp.hardware_spec
        return self.sweep_jobs(exp, [hw], [(0, p) for p in plans],
                               hardware_name=hw.name)

    def sweep_jobs(self, exp, specs: Sequence[HardwareSpec],
                   jobs: Sequence[Job], *, hardware_name: str,
                   num_hardware: int = 1,
                   extra_failed: int = 0) -> SweepReport:
        """Evaluate a flat ``(variant index, plan)`` job stream against the
        given hardware variants through one shared executor and return the
        merged ranked report. ``extra_failed`` accounts for variants that
        failed before any job was enumerated (e.g. too few devices)."""
        specs, jobs = list(specs), list(jobs)
        outcomes, executor = self.evaluate_jobs(exp, specs, jobs)

        runs: List[RunReport] = []
        pruned = failed = 0
        pruned_records: List[Dict] = []
        failed_records: List[Dict] = []
        for job, (tag, payload) in zip(jobs, outcomes):
            if tag == _OK:
                runs.append(payload)
                continue
            variant, plan = job[0], job[1]
            record = {"plan": _plan_summary(plan),
                      "hardware": specs[variant].name}
            if tag == _PRUNED:
                pruned += 1
                if isinstance(payload, dict):
                    record.update(payload)
                if len(pruned_records) < _MAX_RECORDS:
                    pruned_records.append(record)
            else:
                failed += 1
                record["reason"] = payload
                if len(failed_records) < _MAX_RECORDS:
                    failed_records.append(record)
        runs.sort(key=run_rank_key)
        return SweepReport(
            arch=exp.arch_name,
            hardware=hardware_name,
            runs=runs,
            num_candidates=len(jobs),
            num_pruned_memory=pruned,
            num_failed=failed + extra_failed,
            executor=executor,
            num_hardware=num_hardware,
            pruned_records=pruned_records,
            failed_records=failed_records,
            profile=dict(self.last_profile) if self.profile else None,
            metrics=self._report_metrics(exp, outcomes),
        )

    def _report_metrics(self, exp, outcomes) -> Optional[Dict]:
        """SweepReport.metrics document: job-order sim-domain aggregate
        (bit-identical across tiers/executors) + the call's merged host
        registry. None when the experiment did not enable metrics."""
        if not getattr(exp, "metrics", False):
            return None
        from ..obs.simmetrics import aggregate_run_metrics

        return {"sim": aggregate_run_metrics(outcomes),
                "host": self.last_metrics or {}}

    def evaluate_jobs(self, exp, specs: Sequence[HardwareSpec],
                      jobs: Sequence[Job]) -> Tuple[List[Tuple[str, object]], str]:
        """Raw evaluation of a job stream: ``(tag, payload)`` outcomes in
        job order plus the executor label. Jobs may carry a per-job
        fidelity as a third element (multi-fidelity search rungs)."""
        jobs = list(jobs)
        call_profile: Dict[str, int] = {}
        call_registry = make_registry(bool(getattr(exp, "metrics", False)))
        t_call = perf_counter()
        try:
            # a 1-job batch is cheaper in-process — unless a persistent pool
            # exists (or will): search generations can shrink to one candidate
            # and must keep hitting the warm workers
            if self.workers >= 2 and (len(jobs) > 1 or self._persist):
                try:
                    exp_bytes = pickle.dumps(exp)
                    specs_bytes = pickle.dumps(list(specs))
                except Exception as e:   # e.g. lambda graph_builder
                    warnings.warn(
                        f"experiment not picklable ({e}); sweeping serially",
                        RuntimeWarning, stacklevel=3)
                else:
                    initargs = (exp_bytes, specs_bytes, self.return_timelines,
                                self.trace_resources, self.trace_lanes,
                                self.trace_budget_bytes, self.batch_fastpath,
                                str(self.device))
                    if self._persist:
                        key = (exp_bytes, specs_bytes)
                        if self._pool is None or self._pool_key != key:
                            self._shutdown_pool()
                            self._pool = self._new_pool(self.workers, initargs)
                            self._pool_key = key
                            self.pool_inits += 1
                        parts = list(self._pool.map(
                            _eval_shard_in_worker,
                            _shards(jobs, self.workers)))
                        for _, prof, mdoc in parts:
                            _merge_profile(call_profile, prof)
                            call_registry.merge_dict(mdoc)
                        call_registry.counter("host.pool.shards").inc(
                            len(parts))
                        call_registry.gauge("host.pool.workers").set(
                            self.workers)
                        return ([o for out, _, _ in parts for o in out],
                                f"process[{self.workers}]")
                    n = min(self.workers, len(jobs))
                    self.pool_inits += 1
                    with self._new_pool(n, initargs) as pool:
                        parts = list(pool.map(_eval_shard_in_worker,
                                              _shards(jobs, n)))
                    for _, prof, mdoc in parts:
                        _merge_profile(call_profile, prof)
                        call_registry.merge_dict(mdoc)
                    call_registry.counter("host.pool.shards").inc(len(parts))
                    call_registry.gauge("host.pool.workers").set(n)
                    return ([o for out, _, _ in parts for o in out],
                            f"process[{n}]")
            graphs, classify = self._serial_memo(exp)
            outcomes = _evaluate_many(
                exp, list(specs), jobs, graphs,
                return_timelines=self.return_timelines,
                trace_resources=self.trace_resources,
                trace_lanes=self.trace_lanes,
                trace_budget_bytes=self.trace_budget_bytes,
                batch_fastpath=self.batch_fastpath,
                classify_memo=classify,
                profile=call_profile,
                registry=call_registry,
                device=self.device)
            return outcomes, "serial"
        finally:
            self.last_profile = call_profile
            _merge_profile(self.profile_totals, call_profile)
            if call_registry:
                # satellite of the obs layer: the fast-tier phase profile
                # is itself a set of host counters
                for k, v in call_profile.items():
                    call_registry.counter("host.fastbatch." + k).inc(v)
                call_registry.counter("host.sweep.evaluate.us").inc(
                    (perf_counter() - t_call) * 1e6)
                call_registry.counter("host.sweep.evaluate.calls").inc()
                self.last_metrics = call_registry.to_dict()
            else:
                self.last_metrics = None


# -- module-level engine reuse ----------------------------------------------
# One persistent engine per flag combination: planner entry points
# (plan_parallelism / plan_codesign / plan_serving, and the CLI) call
# shared_engine() instead of constructing throwaway engines, so the
# process pool and serial memos stay warm across *calls* — back-to-back
# co-design questions about the same experiment re-pickle nothing.
_SHARED: Dict[Tuple, SweepEngine] = {}


def shared_engine(workers: Optional[int] = 0,
                  return_timelines: bool = False,
                  trace_resources: bool = False,
                  trace_lanes: Optional[Sequence] = None,
                  trace_budget_bytes: Optional[int] = None,
                  device=None) -> SweepEngine:
    """Return the module-level persistent :class:`SweepEngine` for a flag
    combination, creating (and entering) it on first use.

    The engine is already persistent (``__enter__`` has been called):
    its process pool is keyed by the pickled (experiment, specs) pair
    and survives across calls, and its serial-path graph/classifier
    memos stay warm per experiment. Callers must NOT close it — it is
    shared; :func:`close_shared_engines` (registered atexit) tears all
    shared engines down. ``device`` is part of the key: ``None`` is the
    card (raises without one), ``"cpu"`` the host."""
    dev = resolve_device(device)
    key = (os.cpu_count() if workers is None else workers,
           bool(return_timelines), bool(trace_resources),
           _lane_codes(trace_lanes), trace_budget_bytes, str(dev))
    eng = _SHARED.get(key)
    if eng is None:
        eng = SweepEngine(workers=workers,
                          return_timelines=return_timelines,
                          trace_resources=trace_resources,
                          trace_lanes=trace_lanes,
                          trace_budget_bytes=trace_budget_bytes,
                          device=dev)
        eng.__enter__()
        _SHARED[key] = eng
    return eng


def close_shared_engines() -> None:
    """Shut down every :func:`shared_engine` pool (also runs atexit)."""
    for eng in _SHARED.values():
        eng.close()
    _SHARED.clear()


atexit.register(close_shared_engines)
