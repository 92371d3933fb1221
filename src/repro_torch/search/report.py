"""Search accounting that nests into :class:`repro_torch.api.SweepReport`.

A :class:`SearchReport` records what a guided search *spent* and how it
converged: the per-rung promotion history, evaluation counts per
fidelity, and the best-so-far throughput curve indexed by full-fidelity
simulation count (the axis guided search optimizes). It round-trips
through JSON alongside the SweepReport it rides in.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["RungRecord", "SearchReport"]


@dataclass
class RungRecord:
    """One generation / successive-halving rung."""

    rung: int
    fidelity: str           # Fidelity.name the cohort was evaluated at
    evaluated: int          # candidates asked at this rung
    promoted: int           # candidates advanced to the next rung

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RungRecord":
        return cls(**d)


@dataclass
class SearchReport:
    """Guided-search accounting (see module docstring).

    ``budget`` is the full-fidelity simulation budget the strategy was
    given; ``full_fidelity_sims`` what it actually dispatched (cached
    re-asks are free and not counted). ``best_curve`` rows are
    ``[full_fidelity_sims_so_far, best_throughput_so_far]``.
    """

    strategy: str
    seed: int
    budget: int
    space_size: int
    evaluations: int = 0                 # dispatched at any fidelity
    full_fidelity_sims: int = 0
    sims_per_fidelity: Dict[str, int] = field(default_factory=dict)
    rungs: List[RungRecord] = field(default_factory=list)
    best_curve: List[List[float]] = field(default_factory=list)

    def __post_init__(self):
        # normalize to the JSON-native shapes so round-trips compare equal
        self.best_curve = [list(row) for row in self.best_curve]
        self.rungs = [r if isinstance(r, RungRecord) else RungRecord(**r)
                      for r in self.rungs]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(dataclasses.replace(self, rungs=[]))
        d["rungs"] = [r.to_dict() for r in self.rungs]
        return d

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchReport":
        d = dict(d)
        d["rungs"] = [RungRecord.from_dict(r) for r in d.get("rungs", [])]
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SearchReport":
        return cls.from_dict(json.loads(s))

    def summary(self) -> str:
        fid = ", ".join(f"{k}: {v}"
                        for k, v in sorted(self.sims_per_fidelity.items()))
        return (f"{self.strategy} (seed {self.seed}): "
                f"{self.full_fidelity_sims}/{self.space_size} full-fidelity "
                f"sims (budget {self.budget}); evaluations by fidelity: "
                f"{fid or 'none'}")
