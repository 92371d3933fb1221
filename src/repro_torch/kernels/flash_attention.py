"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` for CUDA
tensors, the plain ``ref.flash_attention_ref`` for CPU tensors (ported
from ``repro.kernels.ops``).

The kernel takes strides, so q, k and v may be [B,nh,S,hd] tensors or
[B,nh,S,hd] views of the model's [B,S,nh,hd] layout
(``t.transpose(1, 2)``): no copy either way. The output is allocated in
q's own layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)   # the kernel's instantiations


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,nh,S,hd], k/v [B,nkv,S,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, nh, S, hd = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd or nh % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel is instantiated for head_dim {HEAD_DIMS}, got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # hd contiguous, rows 16-byte aligned for the kernel's vector loads
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd] (kv head of q head h
    is h // (nh // nkv)); fp32 online softmax, fully-masked rows give 0."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v, window)
    code = build.dtype_code(q)
    B, nh, S, hd = q.shape
    out = torch.empty_like(q)           # keeps a dense q's strides: [B,S,nh,hd] views stay so
    if B == 0 or S == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, nh, k.shape[1], S, hd, int(causal), int(window), code, build.stream_of(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
