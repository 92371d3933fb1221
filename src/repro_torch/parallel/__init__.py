"""Distributed runtime of the port (``repro.parallel``'s counterpart): the
sharding rules, the collectives a model on a mesh runs, the GPipe
pipeline and int8 gradient compression."""

from .compression import compressed_psum, dequantize_int8, ef_compress_tree, quantize_int8
from .pipeline import make_pipeline_loss, pipeline_apply
from .sharding import (
    MeshPlacements,
    ShardingPlanner,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
)

__all__ = ["ShardingPlanner", "batch_pspec", "cache_pspecs", "param_pspecs", "MeshPlacements",
           "pipeline_apply", "make_pipeline_loss", "quantize_int8", "dequantize_int8",
           "ef_compress_tree", "compressed_psum"]
