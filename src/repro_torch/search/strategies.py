"""Ask/tell search strategies over an :class:`EncodedSpace`.

Every strategy implements the same protocol: :meth:`ask` returns a batch
of ``(candidate, fidelity)`` pairs to evaluate (one *generation* — the
controller dispatches the whole batch through the shared-pool sweep
engine, so workers stay warm across generations), :meth:`tell` receives
the outcomes in ask order, and an empty ask ends the search. All
randomness flows through one ``random.Random(seed)``, and candidates
inside a generation are ordered by flat index, so fixed-seed runs are
bit-reproducible regardless of the executor (serial vs process pool).

Budget semantics (shared by every strategy and the CLI ``--search-budget``
flag): the budget counts **full-fidelity simulations** — the expensive
evaluations an exhaustive sweep would spend one per candidate. Reduced
rungs (coarser NoC model, truncated microbatch count) are the cheap
currency multi-fidelity strategies trade in; they are accounted in
``SearchReport.sims_per_fidelity`` but not budget-capped.

* :class:`RandomSearch` — the baseline: ``budget`` uniform candidates,
  all at full fidelity.
* :class:`SuccessiveHalving` — evaluates a large cohort at the cheapest
  rung and halves it (keep the top ``1/eta``) while climbing the
  fidelity ladder; the final (full-fidelity) rung is sized so it can
  never exceed the budget.
* :class:`Evolutionary` — (mu + lambda) local search: tournament-selected
  parents produce single-axis mutants (one hardware-axis step or a local
  plan move); meant for large factored hardware spaces where good
  variants cluster along axes.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

from .fidelity import FULL, Fidelity
from .report import RungRecord
from .space import Candidate, EncodedSpace

__all__ = ["EvalOutcome", "Optimizer", "RandomSearch", "SuccessiveHalving",
           "Evolutionary", "STRATEGIES", "make_strategy"]

Ask = List[Tuple[Candidate, Fidelity]]


@dataclass
class EvalOutcome:
    """One evaluation result handed back to :meth:`Optimizer.tell`."""

    candidate: Candidate
    fidelity: Fidelity
    ok: bool                    # simulated successfully (not pruned/failed)
    throughput: float = 0.0     # 0.0 when not ok
    cached: bool = False        # reused a previous evaluation (cost nothing)
    report: Optional[Any] = None    # the RunReport when ok


class Optimizer(Protocol):
    """Ask/tell search driver over an EncodedSpace."""

    def ask(self) -> Ask:
        """Next generation to evaluate; empty list ends the search."""
        ...

    def tell(self, outcomes: List[EvalOutcome]) -> None:
        """Outcomes for the last ask, in ask order."""
        ...

    def rung_records(self) -> List[RungRecord]:
        """Per-generation history for the SearchReport."""
        ...


def _ranked(outcomes: Sequence[EvalOutcome],
            space: EncodedSpace) -> List[EvalOutcome]:
    """Successful outcomes best-first; ties break on flat index so the
    ordering is independent of executor and dict iteration order."""
    return sorted((o for o in outcomes if o.ok),
                  key=lambda o: (-o.throughput,
                                 space.flat_index(o.candidate)))


class RandomSearch:
    """Uniform sampling without replacement at full fidelity."""

    def __init__(self, space: EncodedSpace, budget: int, seed: int = 0):
        self.space = space
        self.budget = max(1, budget)
        self._rng = random.Random(seed)
        self._pending = space.sample_many(self._rng, self.budget)
        self._records: List[RungRecord] = []

    def ask(self) -> Ask:
        batch, self._pending = self._pending, []
        return [(c, FULL) for c in batch]

    def tell(self, outcomes: List[EvalOutcome]) -> None:
        self._records.append(RungRecord(
            rung=len(self._records), fidelity=FULL.name,
            evaluated=len(outcomes), promoted=0))

    def rung_records(self) -> List[RungRecord]:
        return list(self._records)


class SuccessiveHalving:
    """Fidelity-climbing successive halving (Hyperband's inner loop).

    With ladder rungs ``f_0 .. f_{R-1}`` (cheapest first, ``f_{R-1}`` =
    full) and reduction factor ``eta``, the initial cohort holds
    ``min(space, budget * eta^(R-1))`` candidates; rung ``r`` keeps the
    top ``n_0 / eta^r``. The final rung size is additionally clamped to
    ``budget``, so the strategy can never promote past its full-fidelity
    budget.
    """

    def __init__(self, space: EncodedSpace, budget: int, seed: int = 0,
                 ladder: Optional[Sequence[Fidelity]] = None, eta: int = 2):
        if eta < 2:
            raise ValueError("eta must be >= 2")
        self.space = space
        self.budget = max(1, budget)
        self.eta = eta
        self.ladder = list(ladder) if ladder is not None else [FULL]
        if not self.ladder or not self.ladder[-1].is_full:
            raise ValueError("fidelity ladder must end at full fidelity")
        self._rng = random.Random(seed)
        R = len(self.ladder)
        n0 = min(len(space), self.budget * eta ** (R - 1))
        # per-rung cohort budgets; the last is the full-fidelity budget
        self._rung_sizes = [max(1, n0 // eta ** r) for r in range(R)]
        self._rung_sizes[-1] = min(self._rung_sizes[-1], self.budget)
        self._cohort = space.sample_many(self._rng, n0)
        self._rung = 0
        self._records: List[RungRecord] = []

    def ask(self) -> Ask:
        if self._rung >= len(self.ladder) or not self._cohort:
            return []
        fid = self.ladder[self._rung]
        return [(c, fid) for c in self._cohort]

    def tell(self, outcomes: List[EvalOutcome]) -> None:
        nxt = self._rung + 1
        if nxt < len(self.ladder):
            keep = _ranked(outcomes, self.space)[:self._rung_sizes[nxt]]
            cohort = sorted((o.candidate for o in keep),
                            key=self.space.flat_index)
        else:
            cohort = []
        self._records.append(RungRecord(
            rung=self._rung, fidelity=self.ladder[self._rung].name,
            evaluated=len(outcomes), promoted=len(cohort)))
        self._cohort = cohort
        self._rung = nxt

    def rung_records(self) -> List[RungRecord]:
        return list(self._records)


class Evolutionary:
    """(mu + lambda) evolution with tournament selection and the space's
    single-axis mutation operator, at full fidelity throughout."""

    def __init__(self, space: EncodedSpace, budget: int, seed: int = 0,
                 population: Optional[int] = None, tournament: int = 2,
                 max_stalls: int = 3):
        self.space = space
        self.budget = max(1, budget)
        self._rng = random.Random(seed)
        self.population = min(len(space),
                              population or max(4, self.budget // 4))
        self.tournament = max(1, tournament)
        self._pop: List[EvalOutcome] = []
        self._spent = 0                  # unique full-fidelity evaluations
        self._stalls = 0                 # generations that added no new sims
        self.max_stalls = max_stalls
        self._pending = space.sample_many(
            self._rng, min(self.population, self.budget))
        self._records: List[RungRecord] = []

    def _parent(self) -> Candidate:
        k = max(1, min(len(self._pop), self.tournament))
        contenders = [self._pop[self._rng.randrange(len(self._pop))]
                      for _ in range(k)]
        best = max(contenders,
                   key=lambda o: (o.throughput,
                                  -self.space.flat_index(o.candidate)))
        return best.candidate

    def ask(self) -> Ask:
        if self._pending:
            batch, self._pending = self._pending, []
            return [(c, FULL) for c in batch]
        if (self._spent >= self.budget or not self._pop
                or self._stalls >= self.max_stalls):
            return []
        lam = min(self.population, self.budget - self._spent)
        seen = set()
        children: List[Candidate] = []
        for _ in range(lam):
            child = self.space.mutate(self._parent(), self._rng)
            if child.key not in seen:
                seen.add(child.key)
                children.append(child)
        children.sort(key=self.space.flat_index)
        return [(c, FULL) for c in children]

    def tell(self, outcomes: List[EvalOutcome]) -> None:
        fresh = sum(1 for o in outcomes if not o.cached)
        self._spent += fresh
        self._stalls = 0 if fresh else self._stalls + 1
        survivors = _ranked(list(self._pop) + [o for o in outcomes if o.ok],
                            self.space)
        # dedup by candidate (an outcome may re-enter via the cache)
        seen: Dict[Tuple[int, int], None] = {}
        pop: List[EvalOutcome] = []
        for o in survivors:
            if o.candidate.key not in seen:
                seen[o.candidate.key] = None
                pop.append(o)
            if len(pop) >= self.population:
                break
        entered = sum(1 for o in outcomes
                      if o.ok and any(p.candidate.key == o.candidate.key
                                      for p in pop))
        self._records.append(RungRecord(
            rung=len(self._records), fidelity=FULL.name,
            evaluated=len(outcomes), promoted=entered))
        self._pop = pop

    def rung_records(self) -> List[RungRecord]:
        return list(self._records)


STRATEGIES = {
    "random": RandomSearch,
    "sh": SuccessiveHalving,
    "evolve": Evolutionary,
}


def make_strategy(name: str, space: EncodedSpace, budget: int, seed: int = 0,
                  ladder: Optional[Sequence[Fidelity]] = None, **kw):
    """Instantiate a registered strategy by CLI name (``random`` / ``sh``
    / ``evolve``; ``exhaustive`` is the legacy sweep path, not a
    strategy)."""
    if name not in STRATEGIES:
        known = ", ".join(sorted(STRATEGIES) + ["exhaustive"])
        raise ValueError(f"unknown search strategy {name!r}; known: {known}")
    if name == "sh":
        return SuccessiveHalving(space, budget, seed=seed, ladder=ladder, **kw)
    return STRATEGIES[name](space, budget, seed=seed, **kw)
