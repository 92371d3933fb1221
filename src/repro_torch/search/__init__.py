"""Guided multi-fidelity search over joint hardware x parallelism spaces.

The package behind ``Experiment.sweep(strategy=...)``, ``plan_codesign``
co-design search, and ``python -m repro_torch {sweep,plan} --search ...``:

* :class:`EncodedSpace` / :class:`Candidate` — typed, seedable encoding
  of the joint space (discrete plan axes + the factored hardware axes of
  :class:`~repro_torch.api.HardwareSearchSpace`);
* :class:`Fidelity` / :func:`default_ladder` — the simulation-fidelity
  rung model (NoC-model coarsening + microbatch truncation);
* :class:`RandomSearch`, :class:`SuccessiveHalving`,
  :class:`Evolutionary` — ask/tell strategies (:class:`Optimizer`);
* :func:`run_search` — the generation loop over one persistent
  shared-pool :class:`~repro_torch.api.SweepEngine`;
* :class:`SearchReport` — spend/convergence accounting nested into
  :class:`~repro_torch.api.SweepReport`.

See ``docs/search.md`` for the model and budget semantics.
"""

from .fidelity import FULL, Fidelity, default_ladder
from .space import Candidate, EncodedSpace
from .strategies import (
    STRATEGIES,
    EvalOutcome,
    Evolutionary,
    Optimizer,
    RandomSearch,
    SuccessiveHalving,
    make_strategy,
)
from .report import RungRecord, SearchReport
from .engine import run_search

__all__ = [
    "Candidate",
    "EncodedSpace",
    "EvalOutcome",
    "Evolutionary",
    "FULL",
    "Fidelity",
    "Optimizer",
    "RandomSearch",
    "RungRecord",
    "STRATEGIES",
    "SearchReport",
    "SuccessiveHalving",
    "default_ladder",
    "make_strategy",
    "run_search",
]
