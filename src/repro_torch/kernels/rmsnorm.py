"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA tensors, the plain
``ref.rmsnorm_ref`` for CPU tensors (ported from ``repro.kernels.ops``).

The kernel has two versions, picked in ``kernel_path``: ``"rows"`` holds a
bf16 row in registers and reads it once, for H = 256 * v with v in
``ROW_VPL`` (2560, 4096 and 5120, the widths of the served models);
``"loop"`` takes fp32 and every other H that is a multiple of 8.

Forward and backward are the ops ``repro_torch::rmsnorm`` and
``repro_torch::rmsnorm_bwd`` (``build.define_op``: the launch for CUDA
tensors, the plain version for CPU tensors, the CUDA path's checks and
allocations for tensors without storage). Under ``FlopCounterMode`` they
count nothing, as every elementwise op there.

Gradients: ``rmsnorm`` is a ``torch.autograd.Function`` that saves x and w.
Its backward is ``rmsnorm_bwd``: ``csrc/rmsnorm_bwd.cu`` for CUDA tensors,
the plain ``ref.rmsnorm_bwd_ref`` for CPU tensors. ``bwd_kernel_path``
picks its version by a width list of its own, ``BWD_ROW_GROUPS`` (every
width the models train at; the forward keeps its loop version at 1536,
1600 and 3200, where it is near its bound): ``"rows"`` spreads a bf16 row
over 128 threads that hold it in registers (x and dy read once, the dw
partial in registers across rows, one partial row per CTA, one CTA an
SM); ``"loop"`` takes a warp a row and fp32 partial sums per block. A
second launch sums the partial rows in a fixed order and casts.
"""

from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "check_args", "kernel_path", "bwd_kernel_path", "bwd_grid",
           "ROW_VPL", "BWD_MAX_H", "BWD_ROW_GROUPS"]

# 16-byte vectors per lane of the register version's instantiations
# (csrc/rmsnorm.cu rmsnorm_launch)
ROW_VPL = (10, 16, 20)
# the loop backward's dw slices (one fp32 row of H per warp) must fit shared memory
BWD_SMEM = 96 * 1024
BWD_MAX_H = 2 * BWD_SMEM // 4
# the register backward's widths (csrc/rmsnorm_bwd.cu rmsnorm_bwd_launch), each
# with its rows in flight in one CTA: 8 where a row is small (granite-moe's
# and hymba-1.5b's d_model), 4 elsewhere
BWD_ROW_GROUPS = {1536: 8, 1600: 8, 2560: 4, 3200: 4, 4096: 4, 5120: 4}


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
    Looks at shapes, dtypes, strides and addresses only (``build.address``),
    so it runs on any device."""
    build.refuse_dtensor("rmsnorm", x, w)
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x [T,H] and w [H], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"w must match x ({x.dtype}, {x.device}), got {w.dtype}, {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    path = kernel_path(x.dtype, x.shape[1])
    for name, t in (("x", x), ("w", w)):
        if build.address(t) % 16:     # the kernel moves rows in 16-byte vectors
            raise ValueError(f"rmsnorm kernel needs 16-byte aligned tensors, {name} is at "
                             f"address {build.address(t):#x}")
    return path


def _fwd(x, w, eps, launch):
    """The CUDA path on checked arguments: allocate, and with ``launch``
    run the kernel (one launch counted)."""
    path = check_args(x, w)
    T, H = x.shape
    out = torch.empty_like(x)           # fresh from the allocator: aligned
    if T == 0 or not launch:
        return out
    vpl = H // 256 if path == "rows" else 0
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, H,
                                 float(eps), build.dtype_code(x), vpl, build.stream_of(x))
    build.check(err, f"rmsnorm ({path})")
    rmsnorm.launches += 1
    return out


_fwd_op = build.define_op(
    "rmsnorm", "(Tensor x, Tensor w, float eps) -> Tensor",
    cuda=lambda x, w, eps: _fwd(x, w, eps, True), cpu=rmsnorm_ref,
    fake=lambda x, w, eps: _fwd(x, w, eps, False))


def bwd_kernel_path(dtype: torch.dtype, H: int) -> str:
    """The backward's version: ``"rows"`` for bf16 at a ``BWD_ROW_GROUPS``
    width, else ``"loop"``, which takes H up to ``BWD_MAX_H``. Raises on
    what the forward's ``kernel_path`` refuses."""
    kernel_path(dtype, H)
    if dtype == torch.bfloat16 and H in BWD_ROW_GROUPS:
        return "rows"
    if H > BWD_MAX_H:
        raise ValueError(f"rmsnorm backward takes H up to {BWD_MAX_H}, got {H}")
    return "loop"


def bwd_grid(path: str, T: int, H: int, sms: int):
    """(blocks, warps a block) of the backward's first launch; ``blocks`` is
    also the number of fp32 dw partial rows. rows: one CTA an SM of
    ``BWD_ROW_GROUPS[H]`` row groups of 4 warps, at most one group a row.
    loop: 4 warps a block where their four fp32 dw slices fit ``BWD_SMEM``,
    else 1; two blocks an SM, at most one warp a row."""
    if path == "rows":
        groups = BWD_ROW_GROUPS[H]
        return max(1, min(sms, -(-T // groups))), 4 * groups
    warps = 4 if 4 * 4 * H <= BWD_SMEM else 1
    return max(1, min(2 * sms, -(-T // warps))), warps


def _bwd(x, w, dy, eps, launch):
    """The CUDA backward on checked arguments: dx, dw and the fp32 dw
    partial rows, and with ``launch`` the two kernels (one launch
    counted)."""
    check_args(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device} like x, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or build.address(dy) % 16:
        raise ValueError("rmsnorm backward takes a contiguous, 16-byte aligned dy")
    T, H = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if T == 0:
        return dx, dw.zero_()
    path = bwd_kernel_path(x.dtype, H)
    blocks, warps = bwd_grid(path, T, H, build.sms_of(x))
    partial = torch.empty(blocks, H, dtype=torch.float32, device=x.device)
    if not launch:
        return dx, dw
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_bwd_launch(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                     dw.data_ptr(), partial.data_ptr(), T, H, float(eps),
                                     build.dtype_code(x), int(path == "rows"), blocks, warps,
                                     build.stream_of(x))
    build.check(err, f"rmsnorm_bwd ({path})")
    rmsnorm_bwd.launches += 1
    return dx, dw


_bwd_op = build.define_op(
    "rmsnorm_bwd", "(Tensor x, Tensor w, Tensor dy, float eps) -> (Tensor, Tensor)",
    cuda=lambda x, w, dy, eps: _bwd(x, w, dy, eps, True), cpu=rmsnorm_bwd_ref,
    fake=lambda x, w, dy, eps: _bwd(x, w, dy, eps, False))


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-5):
    """(x [T,H], w [H], dy [T,H]) -> (dx in x's type, dw in w's type):
    the op ``repro_torch::rmsnorm_bwd``. CUDA tensors: two kernels
    (``bwd_kernel_path``'s, then the sum of the dw partials), one launch
    counted; CPU tensors: ``ref.rmsnorm_bwd_ref``."""
    build.refuse_dtensor("rmsnorm_bwd", x, w, dy)
    return _bwd_op(x, w, dy, float(eps))


class RMSNorm(torch.autograd.Function):
    """The forward kernel, with ``rmsnorm_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        build.refuse_dtensor("rmsnorm", x, w)
        return _fwd_op(x, w, float(eps))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if dy.device.type != "cpu" and not (dy.is_contiguous() and build.address(dy) % 16 == 0):
            dy = dy.contiguous()
        dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: [T,H]; w: [H] -> [T,H]. fp32 statistics, multiply by w in fp32,
    one cast to x's type. Differentiable in x and w (``RMSNorm``)."""
    return RMSNorm.apply(x, w, eps)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
