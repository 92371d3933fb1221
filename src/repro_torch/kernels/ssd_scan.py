"""Mamba2 SSD scan: the CUDA kernel ``csrc/ssd_scan.cu`` for CUDA tensors,
the plain ``ref.ssd_scan_ref`` for CPU tensors (ported from
``repro.kernels.ops``).

The kernel takes strides, so x may be a [B,nh,S,hp] view of the model's
[B,S,nh,hp] tensor, Bm and Cm column slices of the conv output and dt a
[B,nh,S] view of a [B,S,nh] tensor: no copy in any case. y is allocated
in x's layout (dense, dims in x's stride order).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "HEAD_DIMS", "STATE_DIMS"]

HEAD_DIMS = (16, 32, 64)           # the kernel's instantiations of hp
STATE_DIMS = (16, 32, 64, 128)     # ... and of N


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x [B,nh,S,hp], got {tuple(x.shape)}")
    B, nh, S, hp = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != (B, nh, S) or A.shape != (nh,) or Bm.shape != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan takes x [B,nh,S,hp], dt [B,nh,S], A [nh], Bm/Cm [B,S,N], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if hp not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"SSD kernel is instantiated for hp in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got hp {hp}, N {N}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share a dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_rows(name, t):
    """Unit stride along the last dim, rows 16-byte aligned (the kernel
    stages rows in 16-byte vectors)."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows, got "
                         f"strides {t.stride()} at address {t.data_ptr():#x}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x: [B,nh,S,hp]; dt: [B,nh,S] fp32 (softplus-ed); A: [nh] fp32
    (negative); Bm/Cm: [B,S,N] -> y [B,nh,S,hp] in x's dtype. fp32 inside.

    ``chunk`` sets the plain version's chunk length only: the kernel blocks
    by its own (64 tokens), and in exact arithmetic the result does not
    depend on it."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan runs on CUDA or CPU tensors, got {x.device}")
    _check(x, dt, A, Bm, Cm)
    code = build.dtype_code(x)
    B, nh, S, hp = x.shape
    y = torch.empty_like(x)        # dense, in x's dim order: [B,S,nh,hp] for the model's views
    if B == 0 or S == 0:
        return y
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("y", y)):
        _check_rows(name, t)
    A = A.contiguous()
    strides = (ctypes.c_longlong * 13)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2], *y.stride()[:3])
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                                  Cm.data_ptr(), y.data_ptr(), strides, B, nh, S, hp,
                                  Bm.shape[-1], code, build.stream_of(x))
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
