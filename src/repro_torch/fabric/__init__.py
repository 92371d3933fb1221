"""Scale-out fabric: multi-level interconnect specs, collective
algorithm schedules, and the event-compiling cluster model.

``spec`` and ``collectives`` are pure data/math (no core imports) and
load eagerly; :class:`FabricModel` / :class:`ClusterDRAM` pull in the
event core and load lazily on first attribute access so that
``repro_torch.core.hardware`` can import :class:`FabricSpec` without a cycle.

The port's copy of the reference's ``repro.fabric``, host code like the
event core it compiles into; a fabric job's chains reach the card through
the batched tier (:mod:`repro_torch.core.fastbatch`).
"""

from .collectives import (
    alpha_beta_lower_bound,
    hd_rounds,
    pairwise_rounds,
    ring_rounds,
    rounds_for,
    tree_rounds,
)
from .spec import (
    COLLECTIVE_FAMILIES,
    FABRIC_PRESETS,
    LEVEL_ALGORITHMS,
    FabricLevel,
    FabricSpec,
    board_pair,
    cluster_2x2,
    fabric_spec_from_dict,
    rack_2x2x2,
)

__all__ = [
    "FabricLevel",
    "FabricSpec",
    "FabricModel",
    "ClusterDRAM",
    "FABRIC_PRESETS",
    "COLLECTIVE_FAMILIES",
    "LEVEL_ALGORITHMS",
    "board_pair",
    "cluster_2x2",
    "rack_2x2x2",
    "fabric_spec_from_dict",
    "ring_rounds",
    "tree_rounds",
    "hd_rounds",
    "pairwise_rounds",
    "rounds_for",
    "alpha_beta_lower_bound",
]

_LAZY = {"FabricModel", "ClusterDRAM"}


def __getattr__(name):
    if name in _LAZY:
        from . import model

        return getattr(model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
