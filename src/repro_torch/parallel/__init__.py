"""Distributed runtime of the port: the sharding rules
(``repro.parallel``'s counterpart) and the collectives a model on a mesh
runs. The pipeline and gradient compression are not ported yet (ROADMAP
§1)."""

from .sharding import (
    MeshPlacements,
    ShardingPlanner,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
)

__all__ = ["ShardingPlanner", "batch_pspec", "cache_pspecs", "param_pspecs", "MeshPlacements"]
