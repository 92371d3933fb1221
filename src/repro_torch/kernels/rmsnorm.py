"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA tensors, the plain
``ref.rmsnorm_ref`` for CPU tensors (ported from ``repro.kernels.ops``)."""

from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: [T,H]; w: [H] -> [T,H]. fp32 statistics, multiply by w in fp32,
    one cast to x's type."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm runs on CUDA or CPU tensors, got {x.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x [T,H] and w [H], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"w must match x ({x.dtype}, {x.device}), got {w.dtype}, {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    T, H = x.shape
    if H % 8:
        raise ValueError(f"rmsnorm kernel takes H a multiple of 8, got {H}")
    code = build.dtype_code(x)
    out = torch.empty_like(x)
    if T == 0:
        return out
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.data_ptr() % 16:     # the kernel moves rows in 16-byte vectors
            raise ValueError(f"rmsnorm kernel needs 16-byte aligned tensors, {name} is at "
                             f"address {t.data_ptr():#x}")
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, H,
                                 float(eps), code, build.stream_of(x))
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
