"""Simulation-fidelity rungs for multi-fidelity search.

The PALM simulator exposes two natural cost knobs, and both preserve
the *relative* ordering of candidates well enough to steer a search:

* **NoC model fidelity** (:class:`~repro_torch.core.enums.NoCMode`): the pure
  analytical ring model and the per-collective macro model are orders of
  magnitude cheaper than per-link event-driven simulation;
* **microbatch count**: event count is O(M) in the number of pipeline
  microbatches, and a run truncated to a few microbatches already prices
  the steady-state stage times, collectives and DRAM streams — only the
  ramp-up/ramp-down amortization shifts.

A :class:`Fidelity` bundles both knobs. ``Fidelity()`` (no overrides) is
*full* fidelity: evaluating a candidate under it is exactly the
evaluation the exhaustive sweep performs, which is why final rungs and
final reports are comparable across search strategies.

Reducing the microbatch count only ever *lowers* the per-tile memory
footprint (fewer in-flight microbatches), so a low-fidelity rung never
memory-prunes a candidate the full-fidelity evaluation would keep.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core.enums import NoCMode
from ..core.parallelism import ParallelPlan

__all__ = ["Fidelity", "FULL", "default_ladder"]


@dataclasses.dataclass(frozen=True)
class Fidelity:
    """One simulation-fidelity point; picklable, ships inside pool jobs."""

    name: str = "full"
    noc_mode: Optional[NoCMode] = None       # None = the experiment's mode
    max_microbatches: Optional[int] = None   # None = the plan's full count
    max_requests: Optional[int] = None       # None = the workload's full count
    # simulator tier (repro_torch.core.fastpath): None = the experiment's engine.
    # "auto" is result-preserving (the fast tier is bit-identical when it
    # fires), so it does NOT reduce fidelity — it's a pure cost knob and
    # the natural floor of every ladder.
    engine: Optional[str] = None

    def __post_init__(self):
        if self.noc_mode is not None:
            object.__setattr__(self, "noc_mode", NoCMode(self.noc_mode))
        if self.engine is not None and self.engine not in ("event", "auto",
                                                           "fast"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.max_microbatches is not None and self.max_microbatches < 1:
            raise ValueError("max_microbatches must be >= 1")
        if self.max_requests is not None and self.max_requests < 1:
            raise ValueError("max_requests must be >= 1")
        if self.name == "full" and not self.is_full:
            # a reduced rung must never masquerade as "full" in the
            # accounting — derive a descriptive name instead
            noc = str(self.noc_mode) if self.noc_mode is not None else "noc"
            mb = (f"mb{self.max_microbatches}"
                  if self.max_microbatches is not None else "mball")
            object.__setattr__(self, "name", f"{noc}-{mb}")

    @property
    def is_full(self) -> bool:
        return (self.noc_mode is None and self.max_microbatches is None
                and self.max_requests is None)

    def resolve(self, plan: ParallelPlan, noc_mode: NoCMode,
                engine: str) -> tuple:
        """Apply every knob of this rung to a job's effective
        ``(plan, noc_mode, engine)`` triple (the sweep engine's
        :func:`~repro_torch.api.sweep._prepare` calls this per job). The
        returned engine also decides *batching*: ``"auto"``/``"fast"``
        jobs are grouped by chain shape and priced through the batched
        fast tier (:mod:`repro_torch.core.fastbatch`: a ``chain_replay``
        launch a chain evaluation of a group, on the engine's device), so
        cheap rungs of a ladder evaluate whole generations at once."""
        plan = self.apply(plan)
        if self.noc_mode is not None:
            noc_mode = NoCMode(self.noc_mode)
        if self.engine is not None:
            engine = self.engine
        return plan, noc_mode, engine

    def apply(self, plan: ParallelPlan) -> ParallelPlan:
        """Truncate the plan's microbatch count (the per-iteration batch
        ``microbatch * dp`` — and thus the workload graph — is
        unchanged, so sweep-engine graph memos stay shared)."""
        if self.max_microbatches is None:
            return plan
        if plan.num_microbatches <= self.max_microbatches:
            return plan
        return dataclasses.replace(
            plan,
            global_batch=plan.microbatch * plan.dp * self.max_microbatches)

    def apply_serving(self, serving):
        """Truncate a :class:`~repro_torch.serving.system.ServingSpec`'s request
        count — the serving analogue of :meth:`apply`: a short prefix of
        the arrival stream already prices steady-state batching, KV
        pressure and SLO attainment, so reduced rungs stop simulating the
        whole workload (the gap that previously made ``objective="slo"``
        searches pay full price at every rung)."""
        if self.max_requests is None or serving is None:
            return serving
        wl = serving.workload
        reqs = getattr(wl, "requests", None)
        count = len(reqs) if reqs else wl.num_requests
        if count <= self.max_requests:
            return serving
        kw = {"num_requests": self.max_requests}
        if reqs:
            kw["requests"] = list(reqs)[: self.max_requests]
        return dataclasses.replace(
            serving, workload=dataclasses.replace(wl, **kw))


FULL = Fidelity()


def default_ladder(noc_mode: NoCMode = NoCMode.MACRO,
                   num_rungs: int = 3) -> List[Fidelity]:
    """Cheapest-first fidelity ladder ending at full fidelity.

    ``noc_mode`` is the experiment's own (full-fidelity) NoC model; the
    middle rung steps down event-driven runs to the macro model and
    leaves cheaper modes untouched.
    """
    if not 1 <= num_rungs <= 3:
        raise ValueError("num_rungs must be 1, 2 or 3")
    noc_mode = NoCMode(noc_mode)
    mid_noc = NoCMode.MACRO if noc_mode == NoCMode.DETAILED else noc_mode
    ladder = [
        Fidelity("analytical-mb2", NoCMode.ANALYTICAL, 2, 8, engine="auto"),
        Fidelity(f"{mid_noc}-mb4", mid_noc, 4, 32, engine="auto"),
        FULL,
    ]
    return ladder[3 - num_rungs:]
