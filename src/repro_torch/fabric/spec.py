"""Declarative multi-level scale-out fabric — the chip→board→node→cluster
hierarchy PALM's single-chip model plugs into.

A :class:`FabricSpec` stacks :class:`FabricLevel` entries innermost-first
(board, then node, then cluster, ...). Each level is a switch tier: every
child instance at that level owns one up-link and one down-link to its
parent switch with the level's bandwidth/latency (GPUCluster-style
switched links, see ``repro_torch.core.topology.GPUCluster``). Chips are the
leaves; a chip's id decomposes in mixed radix over the level degrees, so
routing between two chips is "climb to the lowest common ancestor level,
descend" and the traversed link ids are pure arithmetic.

Like :class:`~repro_torch.core.hardware.HardwareSpec`, a fabric is *data*: it
round-trips losslessly through ``to_dict``/``from_dict`` (and
``to_json``/``from_json``), so cluster designs can be dumped, tweaked,
diffed, and swept (``HardwareSearchSpace.fabric_bw``).

This module is import-cycle-free by construction: it depends on nothing
from ``repro_torch.core`` (the event-compiling half lives in
``repro_torch.fabric.model``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

__all__ = [
    "FabricLevel",
    "FabricSpec",
    "fabric_spec_from_dict",
    "FABRIC_PRESETS",
    "board_pair",
    "cluster_2x2",
    "rack_2x2x2",
]

GB = 1e9

# per-level leg algorithms (reduce-scatter/all-gather flavors) and
# cross-chip all-reduce families understood by repro_torch.fabric.model
LEVEL_ALGORITHMS = ("ring", "tree", "hd")
COLLECTIVE_FAMILIES = ("hierarchical", "ring", "tree", "hd")


@dataclass(frozen=True)
class FabricLevel:
    """One switch tier of the scale-out hierarchy.

    ``degree`` children hang off each switch at this level; every child
    has one up-link and one down-link of ``bandwidth`` bytes/s and
    ``latency`` seconds. ``algorithm`` picks the reduce-scatter /
    all-gather flavor hierarchical collectives use *at this level*
    (``ring`` | ``tree`` | ``hd`` halving-doubling).
    """

    name: str
    degree: int
    bandwidth: float          # bytes/s per up/down link
    latency: float = 1e-6     # seconds per link traversal
    algorithm: str = "ring"

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"level {self.name!r}: degree must be >= 1")
        if self.bandwidth <= 0:
            raise ValueError(f"level {self.name!r}: bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError(f"level {self.name!r}: latency must be >= 0")
        if self.algorithm not in LEVEL_ALGORITHMS:
            raise ValueError(
                f"level {self.name!r}: unknown algorithm "
                f"{self.algorithm!r}; known: {', '.join(LEVEL_ALGORITHMS)}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FabricLevel":
        try:
            return cls(**d)
        except TypeError as e:
            raise ValueError(f"bad fabric level dict: {e}") from None


@dataclass(frozen=True)
class FabricSpec:
    """Multi-level fabric: levels innermost-first, chips as leaves.

    ``collective`` is the cross-chip all-reduce family: ``hierarchical``
    (per-level reduce-scatter up / all-gather down, the payload shrinking
    by the participant count at every level) or a flat ``ring`` / ``tree``
    / ``hd`` over all chips.
    """

    levels: Tuple[FabricLevel, ...]
    collective: str = "hierarchical"
    name: str = "fabric"

    def __post_init__(self):
        object.__setattr__(self, "levels", tuple(self.levels))
        if not self.levels:
            raise ValueError("a FabricSpec needs at least one level")
        if self.collective not in COLLECTIVE_FAMILIES:
            raise ValueError(
                f"unknown collective family {self.collective!r}; known: "
                f"{', '.join(COLLECTIVE_FAMILIES)}")

    # -- shape arithmetic ----------------------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def degrees(self) -> Tuple[int, ...]:
        return tuple(l.degree for l in self.levels)

    @property
    def num_chips(self) -> int:
        return math.prod(self.degrees)

    def chips_per_child(self, level: int) -> int:
        """Chips under one *child instance* at ``level`` (the endpoint a
        level-``level`` up/down link pair serves). Level 0 children are
        single chips."""
        return math.prod(self.degrees[:level])

    def chips_per_group(self, level: int) -> int:
        """Chips under one *switch* at ``level``."""
        return math.prod(self.degrees[:level + 1])

    def instances(self, level: int) -> int:
        """Number of child instances at ``level`` (each owns an up/down
        link pair)."""
        return self.num_chips // self.chips_per_child(level)

    # -- link id layout ------------------------------------------------------
    # Level 0 pairs come first, then level 1, ... Within a level, child
    # instance ``i`` owns up-link ``offset + 2*i`` and down-link
    # ``offset + 2*i + 1``.
    def link_offset(self, level: int) -> int:
        return sum(2 * self.instances(l) for l in range(level))

    def num_links(self) -> int:
        return sum(2 * self.instances(l) for l in range(self.num_levels))

    def up_link(self, level: int, chip: int) -> int:
        return self.link_offset(level) + 2 * (chip // self.chips_per_child(level))

    def down_link(self, level: int, chip: int) -> int:
        return self.up_link(level, chip) + 1

    def link_level(self, link_id: int) -> int:
        for level in range(self.num_levels):
            if link_id < self.link_offset(level) + 2 * self.instances(level):
                return level
        raise ValueError(f"link id {link_id} out of range")

    def link_bandwidth(self, link_id: int) -> float:
        return self.levels[self.link_level(link_id)].bandwidth

    def link_latency(self, link_id: int) -> float:
        return self.levels[self.link_level(link_id)].latency

    def ancestor_level(self, a: int, b: int) -> int:
        """Lowest level whose switch covers both chips."""
        for level in range(self.num_levels):
            g = self.chips_per_group(level)
            if a // g == b // g:
                return level
        raise ValueError(f"chips {a} and {b} share no switch "
                         f"(num_chips={self.num_chips})")

    def route(self, src: int, dst: int) -> List[int]:
        """Directed link ids traversed src -> dst: climb through the
        up-links of every level below the common ancestor, then descend
        through the matching down-links."""
        if src == dst:
            return []
        top = self.ancestor_level(src, dst)
        up = [self.up_link(l, src) for l in range(top + 1)]
        down = [self.down_link(l, dst) for l in range(top, -1, -1)]
        return up + down

    # -- derivation ----------------------------------------------------------
    def with_level(self, level: int, **kw: Any) -> "FabricSpec":
        """Copy with one level's fields replaced (search-axis helper)."""
        levels = list(self.levels)
        levels[level] = dataclasses.replace(levels[level], **kw)
        return dataclasses.replace(self, levels=tuple(levels))

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "collective": self.collective,
            "levels": [l.to_dict() for l in self.levels],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FabricSpec":
        try:
            return cls(
                levels=tuple(FabricLevel.from_dict(l) for l in d["levels"]),
                collective=d.get("collective", "hierarchical"),
                name=d.get("name", "fabric"),
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"bad fabric dict: {e}") from None

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "FabricSpec":
        return cls.from_dict(json.loads(s))


def fabric_spec_from_dict(d: Dict[str, Any]) -> FabricSpec:
    return FabricSpec.from_dict(d)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def board_pair() -> FabricSpec:
    """Two chips on one board (smallest multi-chip fabric)."""
    return FabricSpec(
        name="board_pair",
        levels=(FabricLevel("board", degree=2, bandwidth=100 * GB,
                            latency=5e-7),),
    )


def cluster_2x2() -> FabricSpec:
    """2 boards x 2 chips (the 4-chip cluster the docs walk through):
    fast board-level links, slower node-level links."""
    return FabricSpec(
        name="cluster_2x2",
        levels=(
            FabricLevel("board", degree=2, bandwidth=100 * GB, latency=5e-7),
            FabricLevel("node", degree=2, bandwidth=25 * GB, latency=2e-6),
        ),
    )


def rack_2x2x2() -> FabricSpec:
    """Three-tier 8-chip example: 2 chips/board, 2 boards/node, 2 nodes."""
    return FabricSpec(
        name="rack_2x2x2",
        levels=(
            FabricLevel("board", degree=2, bandwidth=100 * GB, latency=5e-7),
            FabricLevel("node", degree=2, bandwidth=25 * GB, latency=2e-6),
            FabricLevel("rack", degree=2, bandwidth=12.5 * GB, latency=5e-6),
        ),
    )


FABRIC_PRESETS = {
    "board_pair": board_pair,
    "cluster_2x2": cluster_2x2,
    "rack_2x2x2": rack_2x2x2,
}
