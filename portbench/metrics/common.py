"""What the per-layer readers share: shares of a roofline or of the peak
over a traced window (``portbench.trace.Trace``)."""

from __future__ import annotations

from typing import Optional, Sequence

from portbench import groups
from portbench.flops import model, peaks


def kernel_time_s(tr, kinds: Sequence[str]) -> float:
    """Device time of the port's kernels ``kinds``, or of cuBLAS for
    ``("gemm",)``."""
    if tuple(kinds) == ("gemm",):
        return tr.time_s(lambda g: g == groups.GEMM)
    return tr.time_s(lambda g: groups.port_kernel(g) in kinds)


def roofline_pct(tr, kinds: Sequence[str]) -> Optional[float]:
    """The launches' summed least time, from their shapes, over their
    summed device time, in percent; None where none ran."""
    spent = kernel_time_s(tr, kinds)
    if spent <= 0 or not any(getattr(tr.work["launches"], k) for k in kinds):
        return None
    return 100.0 * model.bound(tr.work["launches"], kinds) / spent


def mfu_pct(tr, seconds: float) -> Optional[float]:
    """The model's operations of the window's work over ``seconds`` at the
    bf16 peak, in percent."""
    ops = model.flops(tr.work["launches"], model.MODEL_KINDS)
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * ops / seconds / peaks.BF16_FLOPS


def eager_s(tr) -> float:
    """Device time in ops that are neither cuBLAS nor the port's kernels."""
    return tr.time_s(lambda g: groups.layer(g) == "eager")


def idle_pct(tr) -> Optional[float]:
    """One minus pass A's device busy time (the union of its ops'
    intervals) over the host-clock time of the same work run without the
    profiler, in percent: CUPTI stretches the host's side of a window,
    hardly the kernels, so pass A's own window would count its cost as
    idle."""
    plain = tr.work["plain_window_s"]
    if plain <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / plain)
