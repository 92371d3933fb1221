"""Guided-search controller: strategy x EncodedSpace x shared-pool engine.

:func:`run_search` is the generation loop behind
``Experiment.sweep(strategy=...)`` and ``python -m repro_torch sweep/plan
--search ...``: it encodes the Experiment's joint space, instantiates an
ask/tell strategy, and dispatches each generation as one job batch
through a *persistent* :class:`~repro_torch.api.SweepEngine` pool (workers are
initialized once with the pickled experiment + every variant spec and
stay warm across generations — the same execution substrate the
exhaustive sweep uses, so full-fidelity evaluations are identical).

Evaluations are cached by ``(candidate, fidelity)``: a strategy re-asking
a point (e.g. an evolutionary mutation that lands on a known candidate)
costs nothing and is handed the cached outcome with ``cached=True``.

The result is an ordinary ranked :class:`~repro_torch.api.SweepReport` whose
``runs`` are the full-fidelity evaluations, with a nested
:class:`SearchReport` accounting for what the search spent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from .fidelity import Fidelity, default_ladder
from .report import SearchReport
from .space import EncodedSpace
from .strategies import EvalOutcome, make_strategy

if TYPE_CHECKING:
    from ..api.experiment import Experiment
    from ..api.report import SweepReport
    from ..api.sweep import SweepEngine

__all__ = ["run_search"]


def run_search(exp: "Experiment", strategy: str = "sh",
               budget: Optional[int] = None, seed: int = 0,
               workers: Optional[int] = 0,
               return_timelines: bool = False,
               ladder: Optional[Sequence[Fidelity]] = None,
               engine: Optional["SweepEngine"] = None,
               profile: bool = False,
               device=None,
               **strategy_kw) -> "SweepReport":
    """Run a guided search over an Experiment's joint (hardware x plan)
    space and return the ranked SweepReport (full-fidelity runs only)
    with a nested :class:`SearchReport`.

    ``budget`` caps *full-fidelity* simulations and defaults to a fifth
    of the space (the multi-fidelity savings target); ``ladder``
    overrides the default fidelity rungs (cheapest first, ending at full
    fidelity). A caller-provided ``engine`` is used as-is (and not
    closed); otherwise one persistent engine spans all generations.

    ``device`` is where the batched tier replays the jobs that reach it:
    the reduced rungs of :func:`default_ladder` run ``engine="auto"``, so
    their jobs always take the fast tier, and the full rung's do when the
    experiment's ``engine`` is ``"auto"``/``"fast"``; serving-scored jobs
    never do. Signature groups of at least ``min_group`` jobs replay on
    ``device`` (``None`` is the card, and the engine raises at
    construction without one; ``"cpu"`` is the host), smaller ones take
    the scalar tier on the host. A lent ``engine`` keeps its own device.

    ``profile=True`` attaches the fast-tier phase accounting to
    ``SweepReport.profile`` — cumulative totals plus a ``generations``
    list with one per-rung delta per engine call. When the Experiment
    has ``metrics=True`` the report also carries the repro_torch.obs metrics
    document: engine host metrics merged across generations under
    ``host.search.generation`` spans, and a sim-domain aggregate of the
    ranked full-fidelity runs.
    """
    # api imports stay call-time: repro_torch.api imports repro_torch.search lazily too
    from ..api.report import SweepReport
    from ..api.sweep import (_FAILED, _OK, _PRUNED, SweepEngine,
                             _merge_profile)
    from ..obs.registry import make_registry

    space = EncodedSpace.from_experiment(exp)
    if budget is None:
        budget = max(1, math.ceil(len(space) / 5))
    if ladder is None:
        ladder = default_ladder(exp.noc_mode)
    strat = make_strategy(strategy, space, budget=budget, seed=seed,
                          ladder=ladder, **strategy_kw)

    own_engine = engine is None
    if own_engine:
        engine = SweepEngine(
            workers=workers,
            return_timelines=return_timelines or exp.collect_timeline,
            trace_resources=exp.collect_timeline,
            profile=profile,
            device=device)
        engine.__enter__()              # keep one pool across generations

    registry = make_registry(bool(getattr(exp, "metrics", False)))
    profile_totals: Dict[str, int] = {}
    generations: List[Dict[str, int]] = []
    cache: Dict[Tuple[Tuple[int, int], Fidelity], EvalOutcome] = {}
    reports: Dict[Tuple[int, int], object] = {}   # full-fidelity RunReports
    sims_per_fidelity: Dict[str, int] = {}
    evaluations = full_sims = pruned = failed = 0
    best = -math.inf
    best_curve: List[List[float]] = []
    executor: Optional[str] = None
    try:
        while True:
            asks = strat.ask()
            if not asks:
                break
            fresh = [(c, f) for c, f in asks if (c.key, f) not in cache]
            if fresh:
                jobs = []
                for cand, fid in fresh:
                    variant, plan = space.job(cand)
                    jobs.append((variant, plan) if fid.is_full
                                else (variant, plan, fid))
                with registry.span("host.search.generation"):
                    outcomes, label = engine.evaluate_jobs(
                        exp, space.specs, jobs)
                _merge_profile(profile_totals, engine.last_profile)
                generations.append(
                    {"jobs": len(jobs), **engine.last_profile})
                if registry:
                    registry.counter("host.search.evaluations").inc(len(jobs))
                    registry.merge_dict(engine.last_metrics or {})
                if executor is None:    # rung 0 is the largest batch
                    executor = label
                for (cand, fid), (tag, payload) in zip(fresh, outcomes):
                    evaluations += 1
                    sims_per_fidelity[fid.name] = \
                        sims_per_fidelity.get(fid.name, 0) + 1
                    ok = tag == _OK
                    out = EvalOutcome(
                        candidate=cand, fidelity=fid, ok=ok,
                        throughput=payload.throughput if ok else 0.0,
                        report=payload if ok else None)
                    cache[(cand.key, fid)] = out
                    if fid.is_full:
                        full_sims += 1
                        if tag == _PRUNED:
                            pruned += 1
                        elif tag == _FAILED:
                            failed += 1
                        if ok:
                            reports[cand.key] = payload
                            best = max(best, out.throughput)
                            best_curve.append([full_sims, best])
            fresh_keys = {(c.key, f) for c, f in fresh}
            strat.tell([
                cache[(c.key, f)] if (c.key, f) in fresh_keys
                else dataclasses.replace(cache[(c.key, f)], cached=True)
                for c, f in asks])
    finally:
        if own_engine:
            engine.__exit__(None, None, None)

    return _assemble(exp, space, strategy, seed, budget,
                     reports=reports, pruned=pruned, failed=failed,
                     executor=executor or "serial",
                     evaluations=evaluations, full_sims=full_sims,
                     sims_per_fidelity=sims_per_fidelity,
                     rungs=strat.rung_records(), best_curve=best_curve,
                     profile=({**profile_totals, "generations": generations}
                              if profile else None),
                     host_metrics=registry.to_dict() if registry else None)


def _assemble(exp, space: EncodedSpace, strategy: str, seed: int,
              budget: int, *, reports, pruned: int, failed: int,
              executor: str, evaluations: int, full_sims: int,
              sims_per_fidelity, rungs, best_curve,
              profile=None, host_metrics=None) -> "SweepReport":
    """Rank the full-fidelity runs into a SweepReport with the nested
    SearchReport, reusing the Experiment's report-assembly helpers so
    guided and exhaustive reports stay structurally identical."""
    from ..api.report import SweepReport, run_rank_key

    runs = sorted(reports.values(), key=run_rank_key)
    report = SweepReport(
        arch=exp.arch_name,
        hardware=exp._hardware_label(space.num_enumerated),
        runs=runs,
        num_candidates=len(space),
        num_pruned_memory=pruned,
        num_failed=failed + space.extra_failed,
        executor=executor,
        num_hardware=space.num_enumerated,
        search=SearchReport(
            strategy=strategy, seed=seed, budget=budget,
            space_size=len(space), evaluations=evaluations,
            full_fidelity_sims=full_sims,
            sims_per_fidelity=dict(sorted(sims_per_fidelity.items())),
            rungs=rungs, best_curve=best_curve),
        profile=profile)
    if getattr(exp, "metrics", False):
        from ..api.sweep import _OK
        from ..obs.simmetrics import aggregate_run_metrics
        # aggregate the ranked full-fidelity runs (rank order is total and
        # executor-independent, so the sim half stays deterministic);
        # pruned/failed counts come from the search loop, not the fold
        agg = aggregate_run_metrics([(_OK, r) for r in runs])
        agg["pruned"] = pruned
        agg["failed"] = failed + space.extra_failed
        report.metrics = {"sim": agg, "host": host_metrics or {}}
    if exp.hardware_search is not None:
        exp._record_hardware_specs(report, space.specs)
    return report
