"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA tensors, the plain
``ref.rmsnorm_ref`` for CPU tensors (ported from ``repro.kernels.ops``).

The kernel has two versions, picked in ``kernel_path``: ``"rows"`` holds a
bf16 row in registers and reads it once, for H = 256 * v with v in
``ROW_VPL`` (2560, 4096 and 5120, the widths of the served models);
``"loop"`` takes fp32 and every other H that is a multiple of 8.

Gradients: ``rmsnorm`` is a ``torch.autograd.Function`` that saves x and w.
Its backward is ``rmsnorm_bwd``: ``csrc/rmsnorm_bwd.cu`` for CUDA tensors
(dx a warp per row, dw as fp32 partial sums per block, then a second
launch that sums them in a fixed order and casts), the plain
``ref.rmsnorm_bwd_ref`` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "check_args", "bwd_blocks", "kernel_path", "ROW_VPL",
           "BWD_MAX_H"]

# 16-byte vectors per lane of the register version's instantiations
# (csrc/rmsnorm.cu rmsnorm_launch)
ROW_VPL = (10, 16, 20)
# the backward's dw slices (one fp32 row of H per warp) must fit shared memory
BWD_SMEM = 96 * 1024
BWD_MAX_H = 2 * BWD_SMEM // 4


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


def _forward(x, w, eps):
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


def bwd_blocks(T: int, H: int, sms: int):
    """(blocks, warps a block) of the backward: 4 warps a block where their
    four fp32 dw slices fit ``BWD_SMEM``, else 1 (up to ``BWD_MAX_H``);
    two blocks an SM, at most one warp a row."""
    if H > BWD_MAX_H:
        raise ValueError(f"rmsnorm backward takes H up to {BWD_MAX_H}, got {H}")
    warps = 4 if 4 * 4 * H <= BWD_SMEM else 1
    return max(1, min(2 * sms, -(-T // warps))), warps


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-5):
    """(x [T,H], w [H], dy [T,H]) -> (dx in x's type, dw in w's type).
    CUDA tensors: two kernels, one launch counted."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm_bwd runs on CUDA or CPU tensors, got {x.device}")
    check_args(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device} like x, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("rmsnorm backward takes a contiguous, 16-byte aligned dy")
    T, H = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if T == 0:
        return dx, dw.zero_()
    blocks, warps = bwd_blocks(T, H, build.sm_count(x.device.index or 0))
    partial = torch.empty(blocks, H, dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_bwd_launch(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                     dw.data_ptr(), partial.data_ptr(), T, H, float(eps),
                                     build.dtype_code(x), blocks, warps, build.stream_of(x))
    build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dw


class RMSNorm(torch.autograd.Function):
    """The forward kernel, with ``rmsnorm_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if dy.device.type == "cuda" and not (dy.is_contiguous() and dy.data_ptr() % 16 == 0):
            dy = dy.contiguous()
        dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: [T,H]; w: [H] -> [T,H]. fp32 statistics, multiply by w in fp32,
    one cast to x's type. Differentiable in x and w (``RMSNorm``)."""
    return RMSNorm.apply(x, w, eps)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
