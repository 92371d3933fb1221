"""Flash attention: a CUDA kernel for CUDA tensors, the plain
``ref.flash_attention_ref`` for CPU tensors (ported from
``repro.kernels.ops``).

Two CUDA kernels serve it, picked by (dtype, head_dim) in ``kernel_path``:
* ``"wgmma"``, ``csrc/flash_attention.cu``: bf16 at head_dim 64 and 128
  (yi-6b, hymba-1.5b). Warp-specialised, with TMA copies and wgmma
  products, for Hopper.
* ``"mma"``, ``csrc/flash_attention_mma.cu``: fp32 at head_dim 32, 64 and
  128 (plain FMAs, no TF32) and bf16 at head_dim 32 (mma.sync).
There is no fallback between them: a launch that fails raises.

Both take strides, so q, k and v may be [B,nh,S,hd] tensors or
[B,nh,S,hd] views of the model's [B,S,nh,hd] layout (``t.transpose(1, 2)``):
no copy either way. The output is allocated in q's own layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "check_args", "kernel_path", "HEAD_DIMS", "WGMMA_HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)       # head dims some kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 128)     # bf16 head dims of the wgmma kernel


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that serves (dtype, hd): ``"wgmma"`` or ``"mma"``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel is instantiated for head_dim {HEAD_DIMS}, got {hd}")
    if dtype == torch.bfloat16:
        return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"
    if dtype == torch.float32:
        return "mma"
    raise TypeError(f"flash kernel takes float32 or bfloat16, got {dtype}")


def check_args(q, k, v, window) -> str:
    """Raise on what the kernels do not take; return ``kernel_path``.
    Looks at shapes, dtypes, strides and addresses only, so it runs on any
    device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,nh,S,hd], k/v [B,nkv,S,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, nh, S, hd = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd or nh % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    path = kernel_path(q.dtype, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # hd contiguous; rows and base 16-byte aligned, for the 16-byte
        # vector loads and for TMA, which takes only such strides
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous head dim and strides that are multiples "
                             f"of 16 bytes, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned base, got address "
                             f"{t.data_ptr():#x}")
    return path


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd] (kv head of q head h
    is h // (nh // nkv)); fp32 online softmax, fully-masked rows give 0."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    path = check_args(q, k, v, window)
    B, nh, S, hd = q.shape
    out = torch.empty_like(q)           # keeps a dense q's strides: [B,S,nh,hd] views stay so
    if B == 0 or S == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    lib = build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, nh, k.shape[1], S, hd, int(causal), int(window))
    with torch.cuda.device(q.device):
        if path == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, build.stream_of(q))
        else:
            err = lib.flash_attention_mma_launch(*args, build.dtype_code(q), build.stream_of(q))
    build.check(err, f"flash_attention ({path})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
