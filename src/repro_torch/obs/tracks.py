"""Perfetto counter-track series derived from traces and reports.

A counter track is a Chrome-trace ``"ph": "C"`` event stream: one named
series of ``[t_seconds, value]`` samples that Perfetto renders as a
step-line lane next to the duration lanes :func:`repro_torch.core.trace.
chrome_trace` already emits. This module only *builds* the series
(plain ``{name: [[t, v], ...]}`` dicts); ``chrome_trace(counters=...)``
turns them into events on the dedicated counters pid.

Everything here is derived at export time from data the run already
recorded — trace rows or ``ServingReport`` time series — so enabling
counter tracks changes no simulation state and costs nothing until the
user asks for a trace file.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.trace import KIND_DRAM, KIND_FABRIC, KIND_GU, KIND_NOC

__all__ = ["activity_counters", "serving_counters", "metrics_counters"]


def _step_series(intervals) -> List[List[float]]:
    """Turn ``(start, end)`` intervals into a step series counting how
    many are active at each change point (classic +1/-1 sweep).
    ``-1`` deltas sort before ``+1`` at equal timestamps so a lane that
    ends exactly when another begins does not double-count."""
    deltas: List[List[float]] = []
    for st, en in intervals:
        deltas.append([st, 1])
        deltas.append([en, -1])
    deltas.sort(key=lambda d: (d[0], d[1]))
    series: List[List[float]] = []
    active = 0
    for t, d in deltas:
        active += d
        if series and series[-1][0] == t:
            series[-1][1] = active
        else:
            series.append([t, float(active)])
    return series


def activity_counters(trace) -> Dict[str, List[List[float]]]:
    """Occupancy counter series from a finished trace: concurrently
    active compute stages plus busy NoC/DRAM/fabric links over time."""
    if trace is None or len(trace) == 0:
        return {}
    compute = []
    resource: Dict[int, list] = {}
    for s, k, st, en in zip(trace.stage, trace.kind,
                            trace.start, trace.end):
        if s >= 0 and k <= KIND_GU:
            compute.append((float(st), float(en)))
        elif s < 0 and k in (KIND_NOC, KIND_DRAM, KIND_FABRIC):
            resource.setdefault(int(k), []).append((float(st), float(en)))
    out: Dict[str, List[List[float]]] = {}
    if compute:
        out["active_stages"] = _step_series(compute)
    for k, name in ((KIND_NOC, "busy_noc_links"),
                    (KIND_DRAM, "busy_dram_ports"),
                    (KIND_FABRIC, "busy_fabric_links")):
        if k in resource:
            out[name] = _step_series(resource[k])
    return out


def serving_counters(report) -> Dict[str, List[List[float]]]:
    """Counter series for a ``ServingReport``: the queue-depth and
    KV-cache-occupancy time series the serving simulator already
    samples, re-shaped for the trace export."""
    out: Dict[str, List[List[float]]] = {}
    if report.queue_depth:
        out["queue_depth"] = [[t, float(v)] for t, v in report.queue_depth]
    if report.kv_occupancy_bytes:
        out["kv_occupancy_bytes"] = [
            [t, float(v)] for t, v in report.kv_occupancy_bytes]
    return out


def metrics_counters(metrics: Optional[Dict[str, Any]],
                     total_time: float) -> Dict[str, List[List[float]]]:
    """Flat-line counter series for headline sim-domain scalars so the
    trace view shows them alongside the lanes (one sample at t=0, one at
    the end — Perfetto draws the constant)."""
    if not metrics:
        return {}
    sim = metrics.get("sim") or {}
    out: Dict[str, List[List[float]]] = {}
    for key, name in (("bubble_ratio", "bubble_ratio"),):
        v = sim.get(key)
        if isinstance(v, (int, float)):
            out[name] = [[0.0, float(v)], [total_time, float(v)]]
    levels = sim.get("payload_by_level")
    if isinstance(levels, dict):
        for lname, b in levels.items():
            out[f"payload_{lname}_bytes"] = [[0.0, float(b)],
                                             [total_time, float(b)]]
    return out
