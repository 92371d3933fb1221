"""Typed, seedable encoding of the joint hardware x parallelism space.

An :class:`EncodedSpace` materializes the same candidate universe the
exhaustive sweep enumerates — every ``(hardware variant, parallel plan)``
pair derived from an Experiment's :class:`SearchSpace` and optional
:class:`HardwareSearchSpace` — behind an index-based interface search
strategies can sample and mutate:

* a :class:`Candidate` is ``(variant index, plan index)``; the flat
  candidate order matches the exhaustive job stream exactly, which is
  what makes ``--search exhaustive`` bit-identical to the legacy path
  and keeps fixed-seed runs reproducible across serial/pool executors;
* hardware variants keep their *factored* axis structure (the
  mixed-radix digits of :meth:`HardwareSearchSpace.enumerate_specs`'s
  cartesian product), so :meth:`mutate` can take single-axis steps
  through the hardware space instead of teleporting;
* plan lists are enumeration-ordered (nested loops over the SearchSpace
  axes), so small plan-index steps are local moves in plan space.

Enumeration is cheap — no simulation happens here; the simulator budget
is what the strategies in :mod:`repro_torch.search.strategies` manage.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from ..core.hardware import HardwareSpec
from ..core.parallelism import ParallelPlan

if TYPE_CHECKING:                       # avoid importing api at module load
    from ..api.experiment import Experiment

__all__ = ["Candidate", "EncodedSpace"]


@dataclass(frozen=True)
class Candidate:
    """One point of the encoded space: a kept hardware-variant index plus
    a plan index within that variant's enumeration-ordered plan list."""

    variant: int
    plan_index: int

    @property
    def key(self) -> Tuple[int, int]:
        return (self.variant, self.plan_index)


class EncodedSpace:
    """Candidate universe for guided search (see module docstring)."""

    def __init__(self, specs: Sequence[HardwareSpec],
                 plans: Sequence[Sequence[ParallelPlan]],
                 digits: Optional[Sequence[Tuple[int, ...]]] = None,
                 radices: Sequence[Tuple[str, int]] = (),
                 num_enumerated: Optional[int] = None,
                 extra_failed: int = 0):
        if len(specs) != len(plans):
            raise ValueError("one plan list per hardware variant required")
        self.specs = list(specs)
        self.plans = [list(p) for p in plans]
        self.radices = list(radices)        # (hardware axis name, size)
        self.extra_failed = int(extra_failed)
        self.num_enumerated = (len(self.specs) + self.extra_failed
                               if num_enumerated is None else num_enumerated)
        self._digits = list(digits) if digits is not None else \
            [(i,) for i in range(len(self.specs))]
        self._by_digits: Dict[Tuple[int, ...], int] = {
            d: v for v, d in enumerate(self._digits)}
        # flat-index offsets (variant-major, exhaustive job-stream order)
        self._starts: List[int] = []
        total = 0
        for p in self.plans:
            self._starts.append(total)
            total += len(p)
        self._total = total

    # -- construction --------------------------------------------------------
    @classmethod
    def from_experiment(cls, exp: "Experiment") -> "EncodedSpace":
        """Encode an Experiment's joint search space. Variants that cannot
        host any plan (too few devices for explicit degrees / the fixed
        plan) are dropped and counted, mirroring the exhaustive sweep."""
        base = exp.hardware_spec
        hs = exp.hardware_search
        if hs is not None:
            enumerated = hs.enumerate_specs(base)
            radices = [(name, max(1, len(tuple(vals))))
                       for name, vals, _, _ in hs._axes()]
            digit_iter = itertools.product(*(range(r) for _, r in radices))
            all_digits = list(itertools.islice(digit_iter, len(enumerated)))
        else:
            enumerated = [base]
            radices = []
            all_digits = [()]
        specs: List[HardwareSpec] = []
        plans: List[List[ParallelPlan]] = []
        digits: List[Tuple[int, ...]] = []
        failed = 0
        for spec, dg in zip(enumerated, all_digits):
            try:
                plan_list = exp._plans_for(spec)
            except ValueError:
                failed += 1
                continue
            specs.append(spec)
            plans.append(plan_list)
            digits.append(dg)
        return cls(specs, plans, digits=digits, radices=radices,
                   num_enumerated=len(enumerated), extra_failed=failed)

    # -- basics --------------------------------------------------------------
    def __len__(self) -> int:
        return self._total

    def __repr__(self) -> str:
        return (f"EncodedSpace({self._total} candidates, "
                f"{len(self.specs)} hardware variants)")

    def describe(self) -> Dict[str, object]:
        """Axis sizes (introspection / docs)."""
        return {
            "candidates": self._total,
            "hardware_variants": len(self.specs),
            "hardware_axes": {name: size for name, size in self.radices
                              if size > 1},
            "plans_per_variant": [len(p) for p in self.plans],
        }

    def job(self, cand: Candidate) -> Tuple[int, ParallelPlan]:
        """The sweep-engine job for a candidate."""
        return (cand.variant, self.plans[cand.variant][cand.plan_index])

    def jobs(self) -> List[Tuple[int, ParallelPlan]]:
        """Every job in exhaustive enumeration order (variant-major)."""
        return [(v, p) for v, plist in enumerate(self.plans) for p in plist]

    def flat_index(self, cand: Candidate) -> int:
        return self._starts[cand.variant] + cand.plan_index

    def from_flat(self, i: int) -> Candidate:
        if not 0 <= i < self._total:
            raise IndexError(i)
        # starts is sorted; linear scan is fine at these sizes
        v = max(vi for vi, s in enumerate(self._starts) if s <= i
                and self.plans[vi])
        return Candidate(v, i - self._starts[v])

    # -- sampling ------------------------------------------------------------
    def sample(self, rng: random.Random) -> Candidate:
        """One uniform candidate."""
        return self.from_flat(rng.randrange(self._total))

    def sample_many(self, rng: random.Random, k: int) -> List[Candidate]:
        """``k`` distinct candidates (all of them when ``k >= len``),
        returned in flat order for deterministic evaluation batches."""
        k = min(k, self._total)
        if k == self._total:
            ids: Sequence[int] = range(self._total)
        else:
            ids = sorted(rng.sample(range(self._total), k))
        return [self.from_flat(i) for i in ids]

    # -- local moves ---------------------------------------------------------
    def mutate(self, cand: Candidate, rng: random.Random,
               attempts: int = 16) -> Candidate:
        """One local move: step a single hardware axis (mixed-radix digit
        +-1, wrapping) keeping the plan position, or move the plan index
        within the variant (small step, occasionally a uniform re-draw).
        Falls back to a uniform sample when no valid neighbour is found
        (e.g. truncated/failed variants)."""
        for _ in range(attempts):
            hw_axes = [i for i, (_, r) in enumerate(self.radices) if r > 1]
            move_hw = bool(hw_axes) and len(self.specs) > 1 and (
                len(self.plans[cand.variant]) <= 1 or rng.random() < 0.5)
            if move_hw:
                ax = rng.choice(hw_axes)
                step = rng.choice((-1, 1))
                digits = list(self._digits[cand.variant])
                digits[ax] = (digits[ax] + step) % self.radices[ax][1]
                v = self._by_digits.get(tuple(digits))
                if v is None or not self.plans[v]:
                    continue            # truncated by max_specs, or failed
                pi = min(cand.plan_index, len(self.plans[v]) - 1)
                if (v, pi) != cand.key:
                    return Candidate(v, pi)
                continue
            n = len(self.plans[cand.variant])
            if n <= 1:
                continue
            if rng.random() < 0.3:      # occasional uniform re-draw
                pi = rng.randrange(n - 1)
                if pi >= cand.plan_index:
                    pi += 1
            else:                       # local step
                pi = (cand.plan_index + rng.choice((-2, -1, 1, 2))) % n
            if pi != cand.plan_index:
                return Candidate(cand.variant, pi)
        return self.sample(rng)
