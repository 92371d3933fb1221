"""Serving-split planner: pick a ``(data, model)`` mesh for decode.

The simulator half of serving (``repro_torch.serving.serve`` is the
runtime half). Sweeps the 1-token decode
graph over ``dp x tp`` splits of the device count through the PALM
simulator — the same two axes the runtime's ShardingPlanner shards over
(KV-cache batch on ``data``, heads/features on ``model``).

All ``repro_torch.api`` imports happen at call time: ``repro_torch.api.experiment``
imports ``repro_torch.serving`` at module level (for the ``Experiment.serving``
field), so importing api from here at import time would cycle.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ..api.report import SweepReport
    from ..api.sweep import SweepEngine
    from ..configs.base import ArchConfig

__all__ = ["plan_serving"]


def _fmt_bytes(b: float) -> str:
    for scale, suffix in ((1e9, "GB"), (1e6, "MB"), (1e3, "KB")):
        if abs(b) >= scale:
            return f"{b / scale:.2f} {suffix}"
    return f"{b:.0f} B"


def _infeasibility_message(arch_name: str, hw_name: str,
                           report: "SweepReport") -> str:
    """Explain *why* no serving split was feasible from the sweep's
    pruned/failed diagnostic records instead of a bare 'nothing fit'."""
    lines = [f"no feasible serving split for {arch_name} on {hw_name}: "
             f"{report.num_candidates} candidate(s), "
             f"{report.num_pruned_memory} memory-pruned, "
             f"{report.num_failed} failed"]
    for rec in report.pruned_records:
        p = rec.get("plan", {})
        split = f"(dp={p.get('dp', '?')}, tp={p.get('tp', '?')})"
        if "deficit_bytes" in rec:
            lines.append(
                f"  {split}: peak {_fmt_bytes(rec['peak_bytes'])} over the "
                f"{_fmt_bytes(rec['cap_bytes'])} per-tile cap by "
                f"{_fmt_bytes(rec['deficit_bytes'])}")
        else:
            lines.append(f"  {split}: memory-pruned")
    for rec in report.failed_records:
        p = rec.get("plan", {})
        lines.append(f"  (dp={p.get('dp', '?')}, tp={p.get('tp', '?')}): "
                     f"{rec.get('reason', 'failed')}")
    return "\n".join(lines)


def plan_serving(arch: "ArchConfig | str", hardware="tpu_v5e", batch: int = 8,
                 context_len: int = 4096, workers: int = 0,
                 collect_timeline: bool = False,
                 memory_cap: Optional[float] = None,
                 engine: Optional["SweepEngine"] = None):
    """Pick a ``(data, model)`` mesh split for serving by sweeping
    decode-step parallelism through the PALM simulator.

    The decode graph (1-token step against a ``context_len`` KV cache) is
    swept over ``dp x tp`` splits of the device count. Returns
    ``(mesh_axes, SweepReport)`` where ``mesh_axes`` is ``{"data": dp,
    "model": tp}`` for the highest simulated decode throughput.

    ``collect_timeline=True`` attaches each candidate's columnar event
    timeline to ``RunReport.trace`` — the *same*
    :class:`~repro_torch.core.trace.Trace` schema training simulations emit, so
    serving and training timelines can be compared (or rendered through
    :func:`repro_torch.core.trace.chrome_trace`) side by side.

    ``memory_cap`` (bytes per tile) prunes splits whose mapped decode
    graph cannot fit before simulating them; when every split is
    infeasible the raised ``RuntimeError`` lists each pruned split's
    per-tile deficit (from ``SweepReport.pruned_records``) so the caller
    can see *how far* over budget the model is on this machine.

    ``engine`` lends an open persistent :class:`SweepEngine` (its warm
    process pool is reused and never closed here); defaults to the
    module-level :func:`repro_torch.api.sweep.shared_engine` pool so
    repeated planning calls reuse one warm engine. The decode sweep runs
    the event engine, so no job reaches the batched tier or the card: the
    planner is host code and its engine a host one (``device="cpu"``).
    """
    from ..api import Experiment, Layout, SearchSpace, resolve_hardware
    from ..api.sweep import shared_engine
    from ..configs import get_config

    if engine is None:
        engine = shared_engine(workers=workers,
                               return_timelines=collect_timeline,
                               trace_resources=collect_timeline,
                               device="cpu")
    arch = get_config(arch) if isinstance(arch, str) else arch
    hw = resolve_hardware(hardware)
    n = hw.num_devices
    degrees = [(1, dp, n // dp) for dp in range(1, n + 1)
               if n % dp == 0 and batch % dp == 0]
    # one layout and max_plans == len(degrees): every split is simulated
    # (the diversity budget would otherwise keep layout duplicates of
    # low-dp splits and drop the high-dp ones)
    report = Experiment(
        arch=arch,
        hardware=hw,
        search=SearchSpace(degrees=degrees, microbatch_sizes=(1,),
                           layouts=(Layout.S_SHAPE,),
                           max_plans=len(degrees) or 1),
        seq_len=context_len,
        global_batch=batch,
        training=False,
        decode=True,
        memory_cap=memory_cap,
        collect_timeline=collect_timeline,   # full NoC/DRAM lanes in traces
    ).sweep(workers=workers, engine=engine)
    if report.best is None:
        raise RuntimeError(_infeasibility_message(arch.name, hw.name, report))
    best = report.best.plan
    return {"data": best.dp, "model": best.tp}, report
