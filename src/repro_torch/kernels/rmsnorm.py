"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA tensors, the plain
``ref.rmsnorm_ref`` for CPU tensors (ported from ``repro.kernels.ops``).

The kernel has two versions, picked in ``kernel_path``: ``"rows"`` holds a
bf16 row in registers and reads it once, for H = 256 * v with v in
``ROW_VPL`` (2560, 4096 and 5120, the widths of the served models);
``"loop"`` takes fp32 and every other H that is a multiple of 8.
"""

from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "check_args", "kernel_path", "ROW_VPL"]

# 16-byte vectors per lane of the register version's instantiations
# (csrc/rmsnorm.cu rmsnorm_launch)
ROW_VPL = (10, 16, 20)


def kernel_path(dtype: torch.dtype, H: int) -> str:
    """``"rows"`` (bf16, H = 256 * v for v in ROW_VPL) or ``"loop"``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got {dtype}")
    if H % 8:
        raise ValueError(f"rmsnorm kernel takes H a multiple of 8, got {H}")
    if dtype == torch.bfloat16 and H % 256 == 0 and H // 256 in ROW_VPL:
        return "rows"
    return "loop"


def check_args(x, w) -> str:
    """Raise on what the kernel does not take; return ``kernel_path``.
    Looks at shapes, dtypes, strides and addresses only, so it runs on any
    device."""
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x [T,H] and w [H], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"w must match x ({x.dtype}, {x.device}), got {w.dtype}, {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    path = kernel_path(x.dtype, x.shape[1])
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:     # the kernel moves rows in 16-byte vectors
            raise ValueError(f"rmsnorm kernel needs 16-byte aligned tensors, {name} is at "
                             f"address {t.data_ptr():#x}")
    return path


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: [T,H]; w: [H] -> [T,H]. fp32 statistics, multiply by w in fp32,
    one cast to x's type."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm runs on CUDA or CPU tensors, got {x.device}")
    path = check_args(x, w)
    T, H = x.shape
    out = torch.empty_like(x)           # fresh from the allocator: aligned
    if T == 0:
        return out
    vpl = H // 256 if path == "rows" else 0
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, H,
                                 float(eps), build.dtype_code(x), vpl, build.stream_of(x))
    build.check(err, f"rmsnorm ({path})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
