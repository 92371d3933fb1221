"""Sim-domain metric derivation — the deterministic half of ``repro_torch.obs``.

Everything in this module is computed *post hoc* from data both simulator
tiers already agree on bit-for-bit — the plan/mapping structure, the
``compare=True`` scalars of :class:`~repro_torch.core.scheduler.SimResult`
(total time, throughput, byte counters), and the trace's row *multiset*
(identical across tiers; only append order differs, which the canonical
sort here removes). No value depends on wall clock, heap order, executor,
or engine tier, so ``engine=fast`` and ``engine=event`` runs of the same
job — and serial vs pooled sweeps — produce identical documents. That
invariant is what lets the ``"sim"`` half of a run's metrics (the
reference's ``RunReport.metrics["sim"]``) participate in parity tests
while ``["host"]`` never does.

The document shape (JSON-plain, no registry framing):

* ``total_time`` / ``throughput`` / ``bubble_ratio`` — headline scalars;
* ``bytes`` — NoC / DRAM totals (NoC includes fabric, matching
  ``SimResult.noc_bytes``);
* ``stages`` — per-stage flop totals, roofline utilization vs
  ``tile.flops`` (the paper's per-stage "what fraction of peak"), trace
  busy seconds and busy fractions;
* ``bubble`` — decomposition by cause: ``warmup`` (time before a stage's
  first compute row), ``interior`` (gaps between its rows), ``drain``
  (time after its last row), summed over stages; ``warmup + interior +
  drain + busy == num_stages * total_time`` exactly;
* ``resources`` — per-lane-kind busy time / busy fractions, present only
  when the run recorded resource intervals (``collect_timeline=True``);
* ``payload_by_level`` — fabric traffic per hierarchy level (board /
  node / ...), present only for fabric-backed runs with metrics enabled.

:func:`run_metrics` wraps the sim document with the per-run host domain
(engine tier, machine-readable fast-path rejection) into the
``{"sim": ..., "host": ...}`` shape ``SimResult.metrics`` carries.

The port keeps only the numpy path: the trace's columns are numpy arrays,
and numpy's pairwise ``.sum()`` over the canonically sorted columns is
what makes the documents equal to the reference's, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.trace import KIND_BD, KIND_DRAM, KIND_FABRIC, KIND_NOC

import numpy as _np

__all__ = ["sim_metrics", "run_metrics", "aggregate_run_metrics",
           "serving_sim_metrics"]

_RESOURCE_NAMES = {KIND_NOC: "noc", KIND_DRAM: "dram", KIND_FABRIC: "fabric"}

# outcome tags of one plan evaluation, as the reference's sweep engine
# (``repro.api.sweep``) writes them; the port has no sweep engine yet
_OK, _PRUNED = "ok", "pruned"


def _stage_flops(sim) -> List[float]:
    """Per-stage total executed FLOPs per tile for one iteration: M
    forwards, plus M backwards (+ M recompute forwards) when training —
    exactly the compute the FD/BD bodies price via ``_compute_time``."""
    M = sim.plan.num_microbatches
    training = sim.plan.training
    out = []
    for stage in sim.mapped.stages:
        fwd = sum(op.fwd_flops_tile for op in stage.split_ops)
        total = M * fwd
        if training:
            bwd = sum(op.bwd_flops_tile for op in stage.split_ops)
            total += M * bwd
            if sim.recompute:
                total += M * fwd
        out.append(total)
    return out


def _stage_stats(trace, S: int):
    """Per-stage aggregates over the compute rows (``stage >= 0``) in
    canonical ``(stage, start, end, kind, micro)`` order: ``(busy, fdbd,
    first, last, interior)`` where ``fdbd`` counts only FD/BD rows (the
    schedule-level busy definition behind ``SimResult.bubble_ratio``).

    Sums are folded in canonical order, so they are bit-identical across
    engine tiers and executors (the append order is the only thing that
    differs, and the total sort key removes it), by numpy's deterministic
    array reduction, as the reference folds them.
    """
    busy = [0.0] * S
    fdbd = [0.0] * S
    first: List[Optional[float]] = [None] * S
    last: List[Optional[float]] = [None] * S
    interior = [0.0] * S
    if trace is None or len(trace) == 0:
        return busy, fdbd, first, last, interior

    st = _np.asarray(trace.stage)
    ci = _np.flatnonzero(st >= 0)
    if ci.size == 0:
        return busy, fdbd, first, last, interior
    k = _np.asarray(trace.kind)
    m = _np.asarray(trace.micro)
    s0 = _np.asarray(trace.start)
    e0 = _np.asarray(trace.end)
    order = _np.lexsort((m[ci], k[ci], e0[ci], s0[ci], st[ci]))
    ci = ci[order]
    cs = st[ci]
    ck = k[ci]
    cst = s0[ci]
    cen = e0[ci]
    dur = cen - cst
    bounds = _np.searchsorted(cs, _np.arange(S + 1))
    for s in range(S):
        a, b = int(bounds[s]), int(bounds[s + 1])
        if a == b:
            continue
        seg_dur = dur[a:b]
        busy[s] = float(seg_dur.sum())
        fdbd[s] = float(seg_dur[ck[a:b] <= KIND_BD].sum())
        first[s] = float(cst[a])        # sorted by start within stage
        runmax = _np.maximum.accumulate(cen[a:b])
        last[s] = float(runmax[-1])
        if b - a > 1:
            gaps = cst[a + 1:b] - runmax[:-1]
            pos = gaps[gaps > 0]
            if pos.size:
                interior[s] = float(pos.sum())
    return busy, fdbd, first, last, interior


def _resource_stats(trace) -> Dict[int, Tuple[float, int]]:
    """Resource-row (``stage < 0``) aggregates in canonical ``(end,
    start, kind, lane)`` order: ``{kind: (busy_time, lane_count)}``."""
    if trace is None or len(trace) == 0:
        return {}

    st = _np.asarray(trace.stage)
    ri = _np.flatnonzero(st < 0)
    if ri.size == 0:
        return {}
    k = _np.asarray(trace.kind)
    r = _np.asarray(trace.resource)
    s0 = _np.asarray(trace.start)
    e0 = _np.asarray(trace.end)
    order = _np.lexsort((r[ri], k[ri], s0[ri], e0[ri]))
    ri = ri[order]
    rk = k[ri]
    rr = r[ri]
    rdur = e0[ri] - s0[ri]
    out: Dict[int, Tuple[float, int]] = {}
    for kind in _np.unique(rk).tolist():
        mask = rk == kind
        out[int(kind)] = (float(rdur[mask].sum()),
                          int(_np.unique(rr[mask]).size))
    return out


def sim_metrics(sim, result) -> Dict[str, Any]:
    """Deterministic sim-domain document for one finished run (see the
    module docstring for the shape and the bit-identity contract)."""
    S = sim.mapped.num_stages
    total = result.total_time
    tile_flops = sim.hw.tile.flops

    flops = _stage_flops(sim)
    denom = total * tile_flops
    roofline = [f / denom if denom > 0 else 0.0 for f in flops]

    busy, fdbd, first, last, interior = _stage_stats(result.trace, S)
    warmup = [f if f is not None else total for f in first]
    drain = [(total - l) if l is not None else 0.0 for l in last]
    busy_total = sum(busy)
    warm_total = sum(warmup)
    int_total = sum(interior)
    drain_total = sum(drain)
    span = S * total
    bubble_fraction = (1.0 - busy_total / span) if span > 0 else 0.0
    # the schedule-level headline scalar: FD+BD busy only, same
    # definition as SimResult.bubble_ratio but folded from the canonical
    # row order instead of a second trace walk
    bubble_ratio = (1.0 - sum(fdbd) / span) if span > 0 else 0.0

    doc: Dict[str, Any] = {
        "total_time": total,
        "throughput": result.throughput,
        # the trace-derived all-kinds occupancy bubble lives under
        # bubble["fraction"]
        "bubble_ratio": bubble_ratio,
        "bytes": {"noc": result.noc_bytes, "dram": result.dram_bytes},
        "stages": {
            "flops": flops,
            "roofline_utilization": roofline,
            "busy_time": busy,
            "busy_fraction": [b / total if total > 0 else 0.0 for b in busy],
        },
        "bubble": {
            "warmup": warm_total,
            "interior": int_total,
            "drain": drain_total,
            "busy": busy_total,
            "fraction": bubble_fraction,
        },
    }

    res_stats = _resource_stats(result.trace)
    if res_stats:
        resources: Dict[str, Any] = {}
        for k in sorted(res_stats):
            name = _RESOURCE_NAMES.get(k, str(k))
            bt, n_lanes = res_stats[k]
            resources[name] = {
                "busy_time": bt,
                "lanes": n_lanes,
                "busy_fraction": (bt / (n_lanes * total)
                                  if total > 0 and n_lanes else 0.0),
            }
        doc["resources"] = resources

    levels = getattr(sim.noc, "level_bytes", None)
    if levels:
        spec = sim.noc.spec
        doc["payload_by_level"] = {
            spec.levels[lvl].name: levels[lvl] for lvl in sorted(levels)}

    return doc


def run_metrics(sim, result) -> Dict[str, Any]:
    """``RunReport.metrics`` document: the sim-domain derivation above
    plus the per-run host domain (engine provenance and, when the fast
    tier declined the run, a machine-readable rejection)."""
    from ..core.fastpath import reason_code

    host: Dict[str, Any] = {"engine": result.engine}
    reason = getattr(sim, "fastpath_reason", None)
    if reason and result.engine != "fast":
        host["fastpath_rejection"] = {"code": reason_code(reason),
                                      "reason": reason}
    return {"sim": sim_metrics(sim, result), "host": host}


def aggregate_run_metrics(outcomes) -> Dict[str, Any]:
    """Sweep-level sim-domain aggregate over ``(tag, payload)`` outcomes
    in job order (the reference's sweep outcomes: tag ``"ok"`` with a
    report, ``"pruned"``, or anything else for a failure). Only
    ``compare=True`` report scalars are folded, in job order, so the
    aggregate is bit-identical across engine tiers and serial/pool
    executors (the parity the sweep tests assert)."""
    runs = pruned = failed = 0
    total_time = noc = dram = 0.0
    best = 0.0
    for tag, payload in outcomes:
        if tag == _OK:
            runs += 1
            total_time += payload.total_time
            noc += payload.noc_bytes
            dram += payload.dram_bytes
            if payload.throughput > best:
                best = payload.throughput
        elif tag == _PRUNED:
            pruned += 1
        else:
            failed += 1
    return {
        "runs": runs,
        "pruned": pruned,
        "failed": failed,
        "best_throughput": best,
        "total_sim_time": total_time,
        "bytes": {"noc": noc, "dram": dram},
    }


def _series_stats(series) -> Optional[Dict[str, float]]:
    if not series:
        return None
    vals = [v for _, v in series]
    return {"mean": sum(vals) / len(vals), "max": max(vals),
            "last": vals[-1], "samples": len(vals)}


def serving_sim_metrics(report) -> Dict[str, Any]:
    """Sim-domain document for a serving report (the reference's
    ``repro.serving.system.ServingReport``, read by attribute): KV-cache occupancy and queue depth digests plus the
    deterministic step counters — all derived from the seeded simulation,
    never from wall clock."""
    kv: Dict[str, Any] = {"peak_bytes": report.kv_peak_bytes}
    if report.kv_budget_bytes is not None:
        kv["budget_bytes"] = report.kv_budget_bytes
        if report.kv_budget_bytes > 0:
            kv["peak_fraction"] = report.kv_peak_bytes / report.kv_budget_bytes
    occ = _series_stats(report.kv_occupancy_bytes)
    if occ is not None:
        kv["occupancy"] = occ
    doc: Dict[str, Any] = {
        "sim_time": report.sim_time,
        "throughput_rps": report.throughput_rps,
        "goodput_rps": report.goodput_rps,
        "kv_cache": kv,
        "steps": {k: report.steps.get(k, 0)
                  for k in ("prefill", "decode", "cost_sims")},
    }
    queue = _series_stats(report.queue_depth)
    if queue is not None:
        doc["queue_depth"] = queue
    return doc
