"""Architecture configs of the PyTorch port: copies of ``repro.configs``
(the 10 assigned architectures + the paper's Megatron T-series).
``get_config(name)`` resolves by id."""

from .base import ArchConfig, ShapeConfig, SHAPES, shape_applicable
from .registry import ARCHS, PAPER_MODELS, get_config, list_archs

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCHS",
    "PAPER_MODELS",
    "get_config",
    "list_archs",
    "shape_applicable",
]
