"""Request-level serving simulator on the PALM event core.

``repro_torch.serving.system`` answers "what does this (hardware, plan) pair do
under real traffic" instead of "how fast is one step": a seeded
:class:`~.workload.WorkloadSpec` drives arrivals, a
:class:`~.batcher.ContinuousBatcher` schedules iteration-level admission
and KV-cache eviction, and every engine iteration advances a
deterministic :class:`~repro_torch.core.events.Environment` by the *simulated*
cost of that prefill/decode step.

Step costs come from the existing PALM graph simulation: a
:class:`StepCostModel` builds the decode (1-token against a KV span) or
prefill graph for the iteration's batch/context, maps it onto the
hardware with the serving plan, and runs the event-driven
:class:`~repro_torch.core.scheduler.PipelineSimulator` — memoized per
(batch-bucket, context-bucket), so a 10k-request run costs a handful of
graph simulations, not ten thousand (the two-tier fast-path/detailed
split Proteus uses).

The result is a :class:`ServingReport`: TTFT/TPOT/e2e percentiles,
goodput, SLO-attainment curves, queue depth and KV occupancy over time —
JSON-round-trippable like every other report — plus (optionally) a
columnar :class:`~repro_torch.core.trace.Trace` with per-request
PREFILL/DECODE/QUEUE lanes that renders through the same npz/Chrome
exporters as training timelines.

Everything here is deterministic by construction (seeded workload, the
``(time, priority, seq)``-keyed event heap, FIFO/LIFO batcher ordering):
identical specs produce bit-identical reports, in-process or in a pool
worker.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..configs.base import ArchConfig
from ..core.enums import BoundaryMode, NoCMode, Schedule
from ..core.events import Environment, Event
from ..core.hardware import HardwareSpec
from ..core.parallelism import ParallelPlan, map_graph
from ..core.scheduler import PipelineSimulator, plan_memory
from ..core.trace import (
    KIND_DECODE,
    KIND_PREFILL,
    KIND_QUEUE,
    Trace,
    TraceRecorder,
)
from ..core.workload import arch_to_graph
from .batcher import ActiveRequest, ContinuousBatcher, KVCacheModel
from .workload import WorkloadSpec

__all__ = ["ServingSpec", "StepCostModel", "ServingSimulator",
           "ServingReport", "simulate_serving"]


@dataclass
class ServingSpec:
    """Declarative serving-scenario description (what to simulate).

    ``kv_budget_bytes=None`` derives the cluster KV budget from the
    hardware: per-tile DRAM capacity minus the plan's resident footprint
    (the same :func:`~repro_torch.core.scheduler.plan_memory` accounting the
    training simulator prunes on), summed over the tiles the plan uses.
    SLO targets are milliseconds; goodput counts requests meeting both.
    """

    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    slo_ttft_ms: float = 2000.0
    slo_tpot_ms: float = 200.0
    max_batch: int = 32
    kv_budget_bytes: Optional[float] = None
    policy: str = "continuous"              # or "static"
    ctx_bucket: int = 512                   # step-cost context rounding
    slo_scales: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0, 4.0)
    sample_limit: int = 256                 # time-series points kept in report

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["workload"] = self.workload.to_dict()
        d["slo_scales"] = list(self.slo_scales)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingSpec":
        kw = dict(d)
        kw["workload"] = WorkloadSpec.from_dict(kw["workload"])
        kw["slo_scales"] = tuple(kw.get("slo_scales", (0.25, 0.5, 1.0, 2.0, 4.0)))
        return cls(**kw)


class StepCostModel:
    """Memoized per-iteration step costs from the PALM graph simulation.

    One engine iteration is either a prefill over the admitted requests'
    contexts or a single decode step for the running batch. Its cost is
    the event-driven simulated ``total_time`` of the corresponding graph
    (``arch_to_graph(..., decode=True)`` for decode) mapped with the
    serving plan — with the iteration batch rounded up to a
    ``dp * 2^k`` bucket and the context to a ``ctx_bucket`` multiple, so
    runs over thousands of requests reuse a handful of simulations.
    Bucketing rounds *up*: costs are conservative, never optimistic.
    """

    def __init__(self, arch: ArchConfig, hardware: HardwareSpec,
                 plan: ParallelPlan, *,
                 noc_mode: NoCMode = NoCMode.MACRO,
                 boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE,
                 ctx_bucket: int = 512):
        if ctx_bucket < 1:
            raise ValueError("ctx_bucket must be >= 1")
        self.arch = arch
        self.hardware = hardware
        self.plan = plan
        self.noc_mode = NoCMode(noc_mode)
        self.boundary_mode = BoundaryMode(boundary_mode)
        self.ctx_bucket = int(ctx_bucket)
        self._memo: Dict[Tuple[str, int, int], float] = {}
        self.sims = 0           # distinct graph simulations run

    # -- bucketing -----------------------------------------------------------
    def bucket_batch(self, batch: int) -> int:
        dp = max(1, self.plan.dp)
        per_replica = max(1, math.ceil(batch / dp))
        return dp * (1 << (per_replica - 1).bit_length())

    def bucket_ctx(self, ctx: int) -> int:
        return self.ctx_bucket * max(1, math.ceil(ctx / self.ctx_bucket))

    # -- costs ---------------------------------------------------------------
    def prefill_cost(self, batch: int, ctx: int) -> float:
        return self._cost("prefill", batch, ctx)

    def decode_cost(self, batch: int, ctx: int) -> float:
        return self._cost("decode", batch, ctx)

    def _cost(self, kind: str, batch: int, ctx: int) -> float:
        key = (kind, self.bucket_batch(batch), self.bucket_ctx(ctx))
        cost = self._memo.get(key)
        if cost is None:
            cost = self._simulate(*key)
            self._memo[key] = cost
            self.sims += 1
        return cost

    def _plan_for(self, batch: int) -> ParallelPlan:
        """The serving plan resized so one iteration is one micro-batch
        (``microbatch * dp == global_batch == batch``)."""
        dp = max(1, self.plan.dp)
        return dataclasses.replace(
            self.plan, microbatch=batch // dp, global_batch=batch,
            training=False, schedule=Schedule.GPIPE,
            activation_offload=False)

    def _simulate(self, kind: str, batch: int, ctx: int) -> float:
        plan = self._plan_for(batch)
        graph = arch_to_graph(self.arch, ctx, batch, training=False,
                              decode=(kind == "decode"))
        mapped = map_graph(graph, self.hardware, plan)
        sim = PipelineSimulator(mapped, noc_mode=self.noc_mode,
                                boundary_mode=self.boundary_mode)
        return sim.run().total_time

    # -- KV budget -----------------------------------------------------------
    def derive_kv_budget(self) -> float:
        """Cluster-aggregate KV byte budget: per-tile DRAM capacity minus
        the plan's resident per-tile footprint (weights/state via
        :func:`plan_memory` on the smallest decode mapping), summed over
        every tile the plan uses. ``inf``-capacity hardware (abstract
        meshes) yields an unbounded budget."""
        cap = self.hardware.dram.capacity_bytes
        if math.isinf(cap):
            return math.inf
        dp = max(1, self.plan.dp)
        plan = self._plan_for(dp)
        graph = arch_to_graph(self.arch, self.ctx_bucket, dp,
                              training=False, decode=True)
        mapped = map_graph(graph, self.hardware, plan)
        memory, _ = plan_memory(mapped)
        tiles_per_stage = self.plan.dp * self.plan.tp
        budget = sum(max(0.0, cap - m.total) * tiles_per_stage
                     for m in memory)
        if budget <= 0:
            raise ValueError(
                f"no KV-cache headroom: plan resident footprint "
                f"{max(m.total for m in memory):.3g} B/tile >= DRAM "
                f"capacity {cap:.3g} B/tile on {self.hardware.name}")
        return budget


# ---------------------------------------------------------------------------
# metrics helpers
# ---------------------------------------------------------------------------

def _pctl(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over pre-sorted values."""
    if not sorted_vals:
        return 0.0
    idx = max(0, math.ceil(q / 100.0 * len(sorted_vals)) - 1)
    return float(sorted_vals[idx])


def _stats(vals: Sequence[float]) -> Dict[str, float]:
    s = sorted(vals)
    return {
        "p50": _pctl(s, 50), "p90": _pctl(s, 90), "p99": _pctl(s, 99),
        # the builtin sum, as the reference's: equal on one interpreter
        # (compensated since Python 3.12, a left fold before)
        "mean": sum(s) / len(s) if s else 0.0,
        "max": s[-1] if s else 0.0,
    }


def _thin(series: List[List[float]], limit: int) -> List[List[float]]:
    """Deterministic stride downsampling that always keeps the last point."""
    if limit <= 0 or len(series) <= limit:
        return series
    stride = math.ceil(len(series) / limit)
    out = series[::stride]
    if out[-1] is not series[-1]:
        out.append(series[-1])
    return out


@dataclass
class ServingReport:
    """Digest of one traffic-driven serving simulation.

    Latency stats are seconds (keys p50/p90/p99/mean/max) over *completed*
    requests; SLO attainment fractions count rejected requests as misses.
    ``goodput_rps`` is completed-requests-meeting-both-SLOs per second of
    simulated time. ``queue_depth`` / ``kv_occupancy_bytes`` are
    ``[t, value]`` samples taken after every engine iteration
    (downsampled to the spec's ``sample_limit``).
    JSON-round-trips via ``to_json``/``from_json``; the optional
    per-request :class:`Trace` is excluded from JSON and equality, like
    ``RunReport``.
    """

    arch: str
    hardware: str
    plan: ParallelPlan
    num_requests: int
    completed: int
    rejected: int
    preemptions: int
    sim_time: float
    offered_rate: float
    throughput_rps: float
    goodput_rps: float
    tokens_per_s: float
    ttft: Dict[str, float]
    tpot: Dict[str, float]
    e2e: Dict[str, float]
    slo: Dict[str, float]
    slo_curve: List[Dict[str, float]]
    queue_depth: List[List[float]]
    kv_occupancy_bytes: List[List[float]]
    kv_peak_bytes: float
    kv_budget_bytes: Optional[float]        # None = unbounded
    steps: Dict[str, int]
    extra: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Trace] = field(default=None, compare=False, repr=False)
    # repro_torch.obs metrics document ({"sim": ..., "host": ...}) when the
    # simulator ran with metrics=True; the host half is wall-clock so the
    # field stays out of equality (JSON keeps it when present)
    metrics: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                              repr=False)

    @property
    def slo_attainment(self) -> float:
        return self.slo.get("attainment", 0.0)

    def to_dict(self, include_trace: bool = False) -> Dict[str, Any]:
        from ..api.report import plan_to_dict      # api builds on core
        src = dataclasses.replace(self, trace=None) if self.trace is not None \
            else self
        d = dataclasses.asdict(src)
        d["plan"] = plan_to_dict(self.plan)
        d.pop("trace", None)
        if d.get("metrics") is None:
            d.pop("metrics", None)
        if include_trace and self.trace is not None:
            d["trace"] = self.trace.to_dict()
        return d

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingReport":
        from ..api.report import plan_from_dict
        d = dict(d)
        d["plan"] = plan_from_dict(d["plan"])
        trace = d.pop("trace", None)
        if trace is not None:
            d["trace"] = Trace.from_dict(trace)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ServingReport":
        return cls.from_dict(json.loads(s))

    def summary(self) -> str:
        budget = ("unbounded" if self.kv_budget_bytes is None
                  else f"{self.kv_budget_bytes / 1e9:.2f} GB")
        return "\n".join([
            f"{self.arch} on {self.hardware} "
            f"(pp={self.plan.pp} dp={self.plan.dp} tp={self.plan.tp}, "
            f"{self.steps.get('policy', 'continuous')} batching)",
            f"requests:  {self.completed}/{self.num_requests} completed, "
            f"{self.rejected} rejected, {self.preemptions} preemptions",
            f"offered:   {self.offered_rate:.3g} req/s over "
            f"{self.sim_time:.3g} s simulated",
            f"TTFT (s):  p50 {self.ttft['p50']:.4g}  p90 {self.ttft['p90']:.4g}"
            f"  p99 {self.ttft['p99']:.4g}",
            f"TPOT (s):  p50 {self.tpot['p50']:.4g}  p90 {self.tpot['p90']:.4g}"
            f"  p99 {self.tpot['p99']:.4g}",
            f"e2e  (s):  p50 {self.e2e['p50']:.4g}  p90 {self.e2e['p90']:.4g}"
            f"  p99 {self.e2e['p99']:.4g}",
            f"goodput:   {self.goodput_rps:.4g} req/s "
            f"(throughput {self.throughput_rps:.4g} req/s, "
            f"{self.tokens_per_s:.4g} tok/s)",
            f"SLO:       ttft <= {self.slo['ttft_ms']:.4g} ms & tpot <= "
            f"{self.slo['tpot_ms']:.4g} ms -> "
            f"{self.slo['attainment']:.1%} attainment",
            f"KV cache:  peak {self.kv_peak_bytes / 1e9:.3g} GB of {budget}",
        ])


class ServingSimulator:
    """Drives a workload through a continuous batcher on the event core.

    One generator process owns the engine loop (admission -> prefill or
    decode iteration, each advanced by its simulated step cost); a second
    process feeds arrivals and wakes the engine when it is drained. All
    scheduling runs on the deterministic ``(time, priority, seq)`` event
    heap, so identical inputs replay identically.
    """

    def __init__(self, arch: ArchConfig, hardware: HardwareSpec,
                 plan: ParallelPlan, spec: ServingSpec, *,
                 noc_mode: NoCMode = NoCMode.MACRO,
                 boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE,
                 collect_trace: bool = False,
                 metrics: bool = False,
                 cost_model: Optional[StepCostModel] = None):
        self.arch = arch
        self.hardware = hardware
        self.plan = plan
        self.spec = spec
        self.collect_trace = collect_trace
        self.metrics = bool(metrics)
        self.cost = cost_model or StepCostModel(
            arch, hardware, plan, noc_mode=noc_mode,
            boundary_mode=boundary_mode, ctx_bucket=spec.ctx_bucket)

    # -- engine --------------------------------------------------------------
    def run(self) -> ServingReport:
        spec = self.spec
        requests = spec.workload.generate()
        kv = KVCacheModel.from_arch(self.arch, self.hardware.precision_bytes)
        budget = (spec.kv_budget_bytes if spec.kv_budget_bytes is not None
                  else self.cost.derive_kv_budget())
        batcher = ContinuousBatcher(kv, budget, max_batch=spec.max_batch,
                                    policy=spec.policy)
        env = Environment()
        rec = TraceRecorder() if self.collect_trace else None
        samples: List[List[float]] = []     # [t, queue_depth, kv_bytes]
        counts = {"prefill": 0, "decode": 0}
        kv_peak = [0.0]
        wake: List[Optional[Event]] = [None]

        def _wake_engine() -> None:
            evt = wake[0]
            if evt is not None and not evt.triggered:
                evt.succeed()

        def arrivals():
            for req in requests:
                if req.arrival > env.now:
                    yield env.timeout(req.arrival - env.now)
                batcher.add(req, env.now)
                _wake_engine()

        def _sample() -> None:
            used = batcher.kv_used_bytes
            kv_peak[0] = max(kv_peak[0], used)
            samples.append([env.now, float(batcher.queue_depth), used])

        def engine():
            total = len(requests)
            while len(batcher.finished) + len(batcher.rejected) < total:
                if not batcher.running and not batcher.waiting:
                    wake[0] = env.event("serve.wake")
                    yield wake[0]
                    wake[0] = None
                    continue
                admitted = batcher.admit(env.now)
                if admitted:
                    start = env.now
                    ctx = max(a.resume_context for a in admitted)
                    yield env.timeout(
                        self.cost.prefill_cost(len(admitted), ctx))
                    counts["prefill"] += 1
                    batcher.finish_prefill(admitted, env.now)
                    if rec is not None:
                        for a in admitted:
                            if start > a.enqueued_at:
                                rec.request(KIND_QUEUE, a.rid, a.episode,
                                            a.enqueued_at, start)
                            rec.request(KIND_PREFILL, a.rid, a.episode,
                                        start, env.now)
                elif batcher.running:
                    batch = batcher.decode_batch()
                    ctx = max(a.context for a in batch)
                    yield env.timeout(self.cost.decode_cost(len(batch), ctx))
                    counts["decode"] += 1
                    retired, evicted = batcher.finish_decode(env.now)
                    if rec is not None:
                        for a in retired:
                            rec.request(KIND_DECODE, a.rid, a.episode,
                                        a.decode_started_at, env.now)
                        for a in evicted:
                            rec.request(KIND_DECODE, a.rid, a.episode - 1,
                                        a.decode_started_at, env.now)
                _sample()

        from ..obs.registry import make_registry
        registry = make_registry(self.metrics)
        with registry.span("host.serving.run"):
            env.process(arrivals(), name="serve.arrivals")
            done = env.process(engine(), name="serve.engine")
            env.run(until_event=done)

        report = self._report(batcher, env, samples, counts, kv_peak[0],
                              budget, rec)
        if registry:
            registry.counter("host.serving.cost_sims").inc(self.cost.sims)
            registry.counter("host.serving.iterations").inc(
                counts["prefill"] + counts["decode"])
            from ..obs.simmetrics import serving_sim_metrics
            report.metrics = {"sim": serving_sim_metrics(report),
                              "host": registry.to_dict()}
        return report

    # -- report assembly -----------------------------------------------------
    def _report(self, batcher: ContinuousBatcher, env: Environment,
                samples: List[List[float]], counts: Dict[str, int],
                kv_peak: float, budget: float,
                rec: Optional[TraceRecorder]) -> ServingReport:
        spec = self.spec
        finished: List[ActiveRequest] = sorted(batcher.finished,
                                               key=lambda a: a.rid)
        total = len(finished) + len(batcher.rejected)
        sim_time = env.now

        ttfts, tpots, e2es = [], [], []
        per_req: List[Tuple[float, float]] = []     # (ttft, tpot) for SLO
        for a in finished:
            ttft = a.first_token_at - a.req.arrival
            e2e = a.finished_at - a.req.arrival
            n_out = a.req.decode_len
            tpot = ((a.finished_at - a.first_token_at) / (n_out - 1)
                    if n_out > 1 else 0.0)
            ttfts.append(ttft)
            tpots.append(tpot)
            e2es.append(e2e)
            per_req.append((ttft, tpot))

        def attainment(scale: float) -> float:
            if total == 0:
                return 0.0
            t_cap = spec.slo_ttft_ms * scale / 1e3
            p_cap = spec.slo_tpot_ms * scale / 1e3
            ok = sum(1 for t, p in per_req if t <= t_cap and p <= p_cap)
            return ok / total               # rejected requests count as misses

        n_ok = round(attainment(1.0) * total)
        out_tokens = sum(a.req.decode_len for a in finished)
        curve = [{"scale": s, "ttft_ms": spec.slo_ttft_ms * s,
                  "tpot_ms": spec.slo_tpot_ms * s, "attainment": attainment(s)}
                 for s in spec.slo_scales]

        trace = None
        if rec is not None:
            trace = rec.freeze(total_time=sim_time, num_stages=0)

        return ServingReport(
            arch=self.arch.name,
            hardware=self.hardware.name,
            plan=self.plan,
            num_requests=total,
            completed=len(finished),
            rejected=len(batcher.rejected),
            preemptions=batcher.preemptions,
            sim_time=sim_time,
            offered_rate=spec.workload.offered_rate,
            throughput_rps=len(finished) / sim_time if sim_time > 0 else 0.0,
            goodput_rps=n_ok / sim_time if sim_time > 0 else 0.0,
            tokens_per_s=out_tokens / sim_time if sim_time > 0 else 0.0,
            ttft=_stats(ttfts),
            tpot=_stats(tpots),
            e2e=_stats(e2es),
            slo={"ttft_ms": spec.slo_ttft_ms, "tpot_ms": spec.slo_tpot_ms,
                 "attainment": attainment(1.0)},
            slo_curve=curve,
            queue_depth=_thin([[t, q] for t, q, _ in samples],
                              spec.sample_limit),
            kv_occupancy_bytes=_thin([[t, b] for t, _, b in samples],
                                     spec.sample_limit),
            kv_peak_bytes=kv_peak,
            kv_budget_bytes=None if math.isinf(budget) else budget,
            steps={"prefill": counts["prefill"], "decode": counts["decode"],
                   "cost_sims": self.cost.sims, "events": env.event_count,
                   "policy": spec.policy},
            trace=trace,
        )


def simulate_serving(arch: Union[str, ArchConfig],
                     hardware: Union[str, HardwareSpec],
                     plan: Optional[ParallelPlan],
                     spec: ServingSpec, *,
                     noc_mode: NoCMode = NoCMode.MACRO,
                     boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE,
                     collect_trace: bool = False,
                     metrics: bool = False,
                     cost_model: Optional[StepCostModel] = None) -> ServingReport:
    """One traffic-driven serving simulation (resolves registry names).
    ``plan=None`` serves on a single device (pp = dp = tp = 1)."""
    from ..api.experiment import resolve_hardware   # api builds on core
    from ..configs import get_config

    arch = get_config(arch) if isinstance(arch, str) else arch
    hw = resolve_hardware(hardware)
    if plan is None:
        plan = ParallelPlan(pp=1, dp=1, tp=1, microbatch=1, global_batch=1,
                            schedule=Schedule.GPIPE, training=False)
    sim = ServingSimulator(arch, hw, plan, spec, noc_mode=noc_mode,
                           boundary_mode=boundary_mode,
                           collect_trace=collect_trace,
                           metrics=metrics,
                           cost_model=cost_model)
    return sim.run()
