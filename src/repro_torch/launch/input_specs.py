"""Stand-ins for every model input, the counterpart of
``repro.launch.input_specs``: tensors on the meta device (no memory), or
fake tensors where the caller has a ``FakeTensorMode`` active, with the
shapes and dtypes the entry points take.

``train``   -> {tokens|embeds: [G, B_mb, S(, H)], labels: [G, B_mb, S]}
``prefill`` -> {tokens|embeds: [B, S(, H)]}
``decode``  -> (cache, tokens [B] | embeds [B, H], pos)

The cache is ``LM.init_cache``'s on the model's device (on a mesh, each
leaf a DTensor at ``ShardingPlanner.cache``'s placements) and ``pos`` the
Python int that ``serving.serve.make_serve_step`` takes: the last slot,
S - 1, where decode attention reads every slot of the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.lm import LM

__all__ = ["train_input_specs", "prefill_input_specs", "decode_input_specs"]


def _spec(shape, dtype, device="meta") -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def train_input_specs(arch: ArchConfig, shape: ShapeConfig,
                      num_microbatches: int) -> Dict[str, torch.Tensor]:
    G = num_microbatches
    B, S = shape.global_batch // G, shape.seq_len
    batch = {"labels": _spec((G, B, S), torch.int32)}
    if arch.embeds_input:
        batch["embeds"] = _spec((G, B, S, arch.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _spec((G, B, S), torch.int32)
    return batch


def prefill_input_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if arch.embeds_input:
        return {"embeds": _spec((B, S, arch.d_model), torch.bfloat16)}
    return {"tokens": _spec((B, S), torch.int32)}


def decode_input_specs(model: LM, shape: ShapeConfig) -> Tuple[Any, Any, int]:
    """(cache, tokens or embeds, pos) on ``model``'s device."""
    B, S = shape.global_batch, shape.seq_len
    arch = model.arch
    cache = model.init_cache(B, S)          # on a meta model, no memory
    if arch.embeds_input:
        tokens = _spec((B, arch.d_model), torch.bfloat16, model.device)
    else:
        tokens = _spec((B,), torch.int32, model.device)
    return cache, tokens, S - 1
