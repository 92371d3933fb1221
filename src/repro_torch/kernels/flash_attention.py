"""Flash attention: a CUDA kernel for CUDA tensors, the plain
``ref.flash_attention_ref`` for CPU tensors (ported from
``repro.kernels.ops``).

Two CUDA kernels serve it, picked by (dtype, head_dim) in ``kernel_path``:
* ``"wgmma"``, ``csrc/flash_attention.cu``: bf16 at head_dim 64, 80, 128
  and 192 (hymba-1.5b, hubert-xlarge, yi-6b, nemotron-4-340b).
  Warp-specialised, with TMA copies and wgmma products, for Hopper; hd 80
  runs in two 64-column boxes whose columns past 80 TMA zero-fills in
  shared memory; hd 192 in three, over kv tiles of 64 rows.
* ``"mma"``, ``csrc/flash_attention_mma.cu``: fp32 at head_dim 32, 64, 80,
  128 and 192 (plain FMAs, no TF32) and bf16 at head_dim 32 (mma.sync).
There is no fallback between them: a launch that fails raises. Both take
``causal=False`` (hubert-xlarge): every kv tile is live, and the only
mask is the tail past S.

Both take strides, so q, k and v may be [B,nh,S,hd] tensors or
[B,nh,S,hd] views of the model's [B,S,nh,hd] layout (``t.transpose(1, 2)``):
no copy either way. The output is allocated in q's own layout.

Gradients: ``flash_attention`` is a ``torch.autograd.Function`` whose
forward also writes each row's log-sum-exp (LSE, fp32, log2 units; only
when an input needs a gradient) and saves it beside q, k, v and o. Its
backward is ``flash_attention_bwd``, picked by ``bwd_kernel_path``:
* ``"wgmma"``, ``csrc/flash_attention_bwd_wgmma.cu``: bf16 at head_dim 64,
  80, 128 and 192. dK/dV per (kv tile, kv head, batch, slice of the GQA
  group; at hd 192 dV and dK in items of their own) into fp32 partials
  summed in a fixed order, dQ per (q tile, head, batch); TMA and wgmma,
  warp-specialised.
* ``"mma"``, ``csrc/flash_attention_bwd.cu``: fp32 (head_dim 32, 64, 80,
  128, 192) and bf16 at head_dim 32 (mma.sync / FMA).
Both read the forward's LSE and D = rowsum(dO o) from a launch of its own
(``csrc/flash_attention_bwd.cu``); nothing recomputes the row statistics.
CPU tensors take ``ref.flash_attention_bwd_ref``.

Forward and backward are the ops ``repro_torch::flash_attention_fwd`` and
``repro_torch::flash_attention_bwd`` (``build.define_op``: the launch for
CUDA tensors, the plain version for CPU tensors, the CUDA path's checks
and allocations for tensors without storage). ``flops`` and ``bwd_flops``
count their products, for ``FlopCounterMode`` and for the bounds in
``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "check_args",
           "check_bwd_args", "kernel_path", "bwd_kernel_path", "bwd_slices", "lse_stride", "pairs",
           "flops", "bwd_flops",
           "HEAD_DIMS", "WGMMA_HEAD_DIMS"]

HEAD_DIMS = (32, 64, 80, 128, 192)      # head dims some kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 80, 128, 192)    # bf16 head dims of the wgmma kernels
LSE_ROWS = 128                  # the LSE and D rows of a (b, h) are padded to this
# dK/dV work items of the wgmma backward the grid should have per SM
# before the GQA group is split further. yi-6b at S 2048 (64 kv items,
# group 8) read 0.6192 / 0.3962 / 0.2973 / 0.3208 ms at 1 / 2 / 4 / 8
# slices on an H100 (scripts/flash_bwd_probe.py, PERF.md): 4 slices, 256
# items; 8 double the partials' traffic and the K, V loads
BWD_ITEMS_PER_SM = 1.5


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that serves (dtype, hd): ``"wgmma"`` or ``"mma"``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel is instantiated for head_dim {HEAD_DIMS}, got {hd}")
    if dtype == torch.bfloat16:
        return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"
    if dtype == torch.float32:
        return "mma"
    raise TypeError(f"flash kernel takes float32 or bfloat16, got {dtype}")


def bwd_kernel_path(dtype: torch.dtype, hd: int) -> str:
    """The CUDA backward that serves (dtype, hd): ``"wgmma"`` or ``"mma"``
    (the forward's rule, ``kernel_path``)."""
    return kernel_path(dtype, hd)


def bwd_slices(group: int, kv_items: int, sms: int) -> int:
    """How many slices the wgmma backward cuts each kv head's GQA group of
    ``group`` query heads into: the smallest divisor of ``group`` that gives
    ``kv_items`` (kv tiles x kv heads x batch) times it at least
    ``BWD_ITEMS_PER_SM`` work items an SM, else ``group``. Each slice is a
    dK/dV work item of its own with fp32 partials."""
    for d in range(1, group + 1):
        if group % d == 0 and kv_items * d >= BWD_ITEMS_PER_SM * sms:
            return d
    return group


def lse_stride(S: int) -> int:
    """Row stride of the kernels' LSE and D buffers [B, nh, lse_stride(S)]:
    S padded to a multiple of ``LSE_ROWS`` (16-byte aligned rows and whole
    tiles for the bulk copies)."""
    return -(-S // LSE_ROWS) * LSE_ROWS


def pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs the attention of S tokens computes: each query
    i sees min(i + 1, window) keys under a window, i + 1 under the causal
    mask alone, and all S without it (no arch runs a window without the
    causal mask)."""
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flops(B: int, nh: int, S: int, hd: int, causal: bool = True, window: int = 0) -> int:
    """The forward's products: q kᵀ and p v, 2 hd each over every pair."""
    return 4 * B * nh * hd * pairs(S, causal, window)


def bwd_flops(B: int, nh: int, S: int, hd: int, causal: bool = True, window: int = 0) -> int:
    """The backward's products as its bound counts them: five of 2 hd over
    every pair (S = q kᵀ, dP = dO vᵀ, dV, dK, dQ); the kernels recompute S
    and dP for dQ, which the count leaves out."""
    return 5 * 2 * B * nh * hd * pairs(S, causal, window)


def check_args(q, k, v, window) -> str:
    """Raise on what the kernels do not take; return ``kernel_path``.
    Looks at shapes, dtypes, strides and addresses only (``build.address``),
    so it runs on any device."""
    build.refuse_dtensor("flash_attention", q, k, v)
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
        _check_layout(name, t, q.device)
    return path


def _check_layout(name, t, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if not strides_ok(t):
        raise ValueError(f"{name} needs a contiguous head dim and strides that are multiples "
                         f"of 16 bytes, got strides {t.stride()}")
    if build.address(t) % 16:
        raise ValueError(f"{name} needs a 16-byte aligned base, got address "
                         f"{build.address(t):#x}")


def strides_ok(t) -> bool:
    """hd contiguous, rows 16-byte aligned: the 16-byte vector loads and
    TMA take only such strides."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3])


def check_bwd_args(q, k, v, o, do, window) -> str:
    """``check_args`` for the backward, plus o and do: q's shape and dtype,
    the same layout rules. Returns ``bwd_kernel_path``."""
    build.refuse_dtensor("flash_attention_bwd", o, do)
    check_args(q, k, v, window)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} like q, got "
                             f"{t.dtype} {tuple(t.shape)}")
        _check_layout(name, t, q.device)
    return bwd_kernel_path(q.dtype, q.shape[3])


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(*(s for t in ts for s in t.stride()[:3]))


def _lse_buffer(B, nh, S, device, dtype=torch.float32) -> torch.Tensor:
    """An LSE or D buffer as the kernels take it, seen as [B, nh, S]."""
    return torch.empty(B, nh, lse_stride(S), dtype=dtype, device=device)[..., :S]


def _fwd(q, k, v, causal, window, lse, launch):
    """The CUDA forward on checked arguments: o and, with ``lse``, the LSE
    buffer (else an empty tensor); with ``launch`` the kernel (one launch
    counted)."""
    path = check_args(q, k, v, window)
    B, nh, S, hd = q.shape
    out = torch.empty_like(q)           # keeps a dense q's strides: [B,S,nh,hd] views stay so
    row_lse = _lse_buffer(B, nh, S, q.device) if lse else q.new_empty(0, dtype=torch.float32)
    if B == 0 or S == 0 or not launch:
        return out, row_lse
    lib = build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            row_lse.data_ptr() if lse else None, _strides(q, k, v, out),
            B, nh, k.shape[1], S, hd, int(causal), int(window), lse_stride(S))
    with torch.cuda.device(q.device):
        if path == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, build.stream_of(q))
        else:
            err = lib.flash_attention_mma_launch(*args, build.dtype_code(q), build.stream_of(q))
    build.check(err, f"flash_attention ({path})")
    flash_attention.launches += 1
    return out, row_lse


def _fwd_plain(q, k, v, causal, window, lse):
    """The plain forward, its outputs in the CUDA path's layouts (o in q's,
    the LSE in the kernels' padded rows)."""
    o = torch.empty_like(q)
    if not lse:
        o.copy_(flash_attention_ref(q, k, v, causal=causal, window=window))
        return o, q.new_empty(0, dtype=torch.float32)
    ref_o, ref_lse = flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    row_lse = _lse_buffer(*q.shape[:3], q.device, ref_lse.dtype)    # fp64 for fp64 inputs
    o.copy_(ref_o)
    row_lse.copy_(ref_lse)
    return o, row_lse


_fwd_op = build.define_op(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, bool lse) -> (Tensor, Tensor)",
    cuda=lambda *a: _fwd(*a, launch=True), cpu=_fwd_plain,
    fake=lambda *a: _fwd(*a, launch=False))


@register_flop_formula(_fwd_op)
def _fwd_op_flops(q, k, v, causal, window, lse, *, out_shape=None, **kwargs) -> int:
    B, nh, S, hd = q
    return flops(B, nh, S, hd, causal, window)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0, lse: bool = True):
    """(o, lse or None): the forward, and with ``lse`` each row's
    log-sum-exp (``ref.flash_attention_fwd_ref``'s definition: fp32
    [B,nh,S], log2 units of the scaled scores), which the backward reads.
    The op ``repro_torch::flash_attention_fwd``. On CUDA tensors the LSE is
    a [B,nh,S] view of a buffer whose rows are ``lse_stride(S)`` apart."""
    build.refuse_dtensor("flash_attention", q, k, v)
    o, row_lse = _fwd_op(q, k, v, bool(causal), int(window), bool(lse))
    return o, (row_lse if lse else None)


def _kernel_lse(lse, B, nh, S):
    """``lse`` as the kernels read it: rows ``lse_stride(S)`` apart, 16-byte
    aligned; anything else (a caller's own [B,nh,S] tensor) is copied so."""
    ld = lse_stride(S)
    if (lse.shape != (B, nh, S) or lse.dtype != torch.float32
            or lse.stride() != (nh * ld, ld, 1) or build.address(lse) % 16):
        buf = _lse_buffer(B, nh, S, lse.device)
        buf.copy_(lse)
        return buf
    return lse


def _bwd(q, k, v, o, do, lse, causal, window, slices, launch):
    """The CUDA backward on checked arguments: dq, dk, dv, the D buffer and
    the wgmma path's fp32 partials; with ``launch`` the kernels (one launch
    counted)."""
    path = check_bwd_args(q, k, v, o, do, window)
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk, dv
    lse = _kernel_lse(lse, B, nh, S)
    delta = _lse_buffer(B, nh, S, q.device)
    parts, gs = None, 1
    if path == "wgmma":
        gs = slices or bwd_slices(nh // nkv, -(-S // 128) * nkv * B, build.sms_of(q))
        if gs < 1 or (nh // nkv) % gs:
            raise ValueError(f"slices must divide the GQA group {nh // nkv}, got {gs}")
        # fp32 partial dK and dV of each slice; none when one slice
        if gs > 1:
            parts = torch.empty(2, gs, B, nkv, S, hd, dtype=torch.float32, device=q.device)
    if not launch:
        return dq, dk, dv
    ld = lse_stride(S)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = build.stream_of(q)
        err = lib.flash_attention_bwd_delta_launch(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), _strides(o, do), B, nh, S, hd, ld,
            build.dtype_code(q), stream)
        build.check(err, "flash_attention_bwd (D)")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr())
        strides = _strides(q, k, v, do, dq, dk, dv)
        if path == "wgmma":
            err = lib.flash_attention_bwd_wgmma_launch(
                *ptrs, parts.data_ptr() if parts is not None else None, strides, B, nh, nkv,
                S, hd, int(causal), int(window), ld, gs, stream)
        else:
            err = lib.flash_attention_bwd_launch(*ptrs, strides, B, nh, nkv, S, hd, int(causal),
                                                 int(window), ld, build.dtype_code(q), stream)
    build.check(err, f"flash_attention_bwd ({path})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _bwd_plain(q, k, v, o, do, lse, causal, window, slices):
    """The plain backward, dq, dk, dv in their inputs' layouts."""
    grads = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    return tuple(torch.empty_like(t).copy_(g) for t, g in zip((q, k, v), grads))


_bwd_op = build.define_op(
    "flash_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, Tensor lse, bool causal, int window, "
    "int slices) -> (Tensor, Tensor, Tensor)",
    cuda=lambda *a: _bwd(*a, launch=True), cpu=_bwd_plain,
    fake=lambda *a: _bwd(*a, launch=False))


@register_flop_formula(_bwd_op)
def _bwd_op_flops(q, k, v, o, do, lse, causal, window, slices, *, out_shape=None,
                  **kwargs) -> int:
    B, nh, S, hd = q
    return bwd_flops(B, nh, S, hd, causal, window)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window: int = 0,
                        slices: int = 0):
    """(q, k, v, o and lse = flash_attention_fwd(q, k, v), do = dL/do) ->
    (dq, dk, dv), each in its input's type and layout; the op
    ``repro_torch::flash_attention_bwd``. CUDA tensors: one launch counted,
    which runs D = rowsum(do o) per (b, h, row), then the
    ``bwd_kernel_path`` kernels (wgmma: dK/dV into per-slice fp32 partials,
    dQ, the fixed-order sum of the partials; mma: dK/dV looping over the
    group, dQ). ``slices`` overrides ``bwd_slices`` (a divisor of the GQA
    group; wgmma path only). CPU tensors: ``ref.flash_attention_bwd_ref``."""
    build.refuse_dtensor("flash_attention_bwd", q, k, v, o, do, lse)
    return _bwd_op(q, k, v, o, do, lse, bool(causal), int(window), int(slices))


class FlashAttention(torch.autograd.Function):
    """The forward kernel, with ``flash_attention_bwd`` as its gradient.
    The LSE is written (and saved) only when a gradient will be taken
    (``need_lse``: grad mode on and an input that requires grad)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, need_lse):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, lse=need_lse)
        if need_lse:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if do.device.type != "cpu" and not (strides_ok(do) and build.address(do) % 16 == 0):
            do = do.contiguous()        # e.g. a broadcast gradient (stride 0)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd] (kv head of q head h
    is h // (nh // nkv)); fp32 online softmax, fully-masked rows give 0.
    Differentiable in q, k and v (``FlashAttention``)."""
    need_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, need_lse)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
