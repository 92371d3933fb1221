"""Typed configuration enums for the simulator front door.

These are the canonical spelling for every mode/schedule/layout kwarg.
All enums subclass ``str``, so the canonical value strings construct the
member directly (``NoCMode("macro") is NoCMode.MACRO``) and comparisons
like ``plan.schedule == "gpipe"`` keep working; anything else raises
``ValueError`` listing the accepted values. The legacy case-insensitive
string-coercion path (and its DeprecationWarnings) was removed one
release after the enums landed — pass the enum member or its exact
value.
"""

from __future__ import annotations

import enum

__all__ = ["NoCMode", "BoundaryMode", "Schedule", "Layout"]


class _StrEnum(str, enum.Enum):
    def __str__(self) -> str:  # argparse/json print the bare value
        return self.value

    @classmethod
    def _missing_(cls, value):
        valid = ", ".join(repr(m.value) for m in cls)
        raise ValueError(
            f"unknown {cls.__name__} {value!r}; expected one of {valid}")


class NoCMode(_StrEnum):
    """NoC model fidelity (§IV-C ❷): per-link event-driven, per-collective
    closed form on the real topology, or pure analytical ring model."""

    DETAILED = "detailed"
    MACRO = "macro"
    ANALYTICAL = "analytical"


class BoundaryMode(_StrEnum):
    """Stage-boundary Act/Grad Pass model: rank-i -> rank-i P2P pairs, or
    the inter-tile-group strategies of Fig. 11."""

    PAIRWISE = "pairwise"
    STRATEGY = "strategy"


class Schedule(_StrEnum):
    """Pipeline schedule (Table II)."""

    GPIPE = "gpipe"
    ONE_F_ONE_B = "1f1b"


class Layout(_StrEnum):
    """Spatial stage layout on the 2-D mesh (Fig. 8)."""

    LINE = "line"
    S_SHAPE = "s_shape"
