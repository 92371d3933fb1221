"""Mamba2 SSD scan: a CUDA kernel for CUDA tensors, the plain
``ref.ssd_scan_ref`` for CPU tensors (ported from ``repro.kernels.ops``).

Two CUDA paths serve it, picked by (dtype, hp, N) in ``kernel_path``:
* ``"wgmma"``, ``csrc/ssd_scan.cu``: bf16 at hp 64 and N 64 or 128
  (mamba2-2.7b). Three launches: C.B^T once per (b, chunk) for all heads,
  the end state of each segment of the sequence from a zero state, then
  the scan over (segment, h, b) with wgmma products and TMA copies. It also
  takes an ``initial_state`` and returns the final state on request.
* ``"fma"``, ``csrc/ssd_scan_fma.cu``: fp32 at every instantiated (hp, N)
  and bf16 elsewhere (hymba-1.5b's N 16): one CTA per (b, h), fp32 FMAs.
There is no fallback between them: a launch that fails raises.

There is no backward kernel yet (ROADMAP queue 2): on CUDA tensors
``ssd_scan`` raises when autograd would need one, rather than return a y
that carries no gradient. CPU tensors go through the plain version, which
autograd differentiates.

Both take strides, so x may be a [B,nh,S,hp] view of the model's
[B,S,nh,hp] tensor, Bm and Cm column slices of the conv output and dt a
[B,nh,S] view of a [B,S,nh] tensor: no copy in any case. y is allocated
in x's layout (dense, dims in x's stride order).
"""

from __future__ import annotations

import ctypes
import torch

from . import build
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "check_args", "kernel_path", "segment_chunks", "launch_fma", "HEAD_DIMS",
           "STATE_DIMS", "WGMMA_STATE_DIMS", "KERNEL_CHUNK"]

HEAD_DIMS = (16, 32, 64)           # hp some kernel is instantiated for
STATE_DIMS = (16, 32, 64, 128)     # ... and N
WGMMA_STATE_DIMS = (64, 128)       # N of the bf16 wgmma path (hp 64)
KERNEL_CHUNK = 64                  # tokens per chunk in both CUDA kernels


def kernel_path(dtype: torch.dtype, hp: int, N: int) -> str:
    """The CUDA kernel that serves (dtype, hp, N): ``"wgmma"`` or ``"fma"``."""
    if hp not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"SSD kernel is instantiated for hp in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got hp {hp}, N {N}")
    if dtype == torch.bfloat16:
        return "wgmma" if hp == 64 and N in WGMMA_STATE_DIMS else "fma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"SSD kernel takes float32 or bfloat16, got {dtype}")


def _check_rows(name, t):
    """Unit stride along the last dim, rows 16-byte aligned (the FMA kernel
    stages rows in 16-byte vectors; TMA takes only such strides and bases)."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows, got "
                         f"strides {t.stride()} at address {t.data_ptr():#x}")


def check_args(x, dt, A, Bm, Cm, initial_state=None, return_state=False) -> str:
    """Raise on what the kernels do not take; return ``kernel_path``. Looks
    at shapes, dtypes, strides and addresses only, so it runs on any
    device."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x [B,nh,S,hp], got {tuple(x.shape)}")
    B, nh, S, hp = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != (B, nh, S) or A.shape != (nh,) or Bm.shape != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan takes x [B,nh,S,hp], dt [B,nh,S], A [nh], Bm/Cm [B,S,N], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share a dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    path = kernel_path(x.dtype, hp, N)
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if (initial_state is not None or return_state) and path != "wgmma":
        raise ValueError(f"initial_state / return_state are served by the wgmma path only "
                         f"(bf16, hp 64, N in {WGMMA_STATE_DIMS}), got {x.dtype}, hp {hp}, N {N}")
    if initial_state is not None:
        if initial_state.shape != (B, nh, hp, N) or initial_state.dtype != torch.float32:
            raise ValueError(f"initial_state must be float32 [B,nh,hp,N] = {(B, nh, hp, N)}, got "
                             f"{initial_state.dtype} {tuple(initial_state.shape)}")
        if initial_state.device != x.device:
            raise ValueError(f"initial_state is on {initial_state.device}, x on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        _check_rows(name, t)
    return path


def segment_chunks(B: int, nh: int, S: int, sms: int) -> int:
    """Chunks per segment of the wgmma path. The scan runs B*nh*n_seg CTAs,
    two to an SM, each over ceil(nc / n_seg) chunks, so its time goes as
    waves x chunks per segment; each segment past the first adds about two
    chunks' worth (its CTAs in the segment-state kernel, and a pass over
    its end state in every later segment). Takes the n_seg with the least
    such cost, the fewest segments on a tie. Fitted to a sweep at
    mamba2-2.7b prefill (B 2, nh 80, S 2000, 132 SMs; PERF.md): 3
    segments of 11 chunks, 480 CTAs."""
    nc = -(-S // KERNEL_CHUNK)
    best, best_cost = nc, None
    for n in range(1, nc + 1):
        seg = -(-nc // n)
        n_seg = -(-nc // seg)
        cost = -(-B * nh * n_seg // (2 * sms)) * seg + 2 * (n_seg - 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = seg, cost
    return best


def _strides(x, dt, Bm, Cm, y):
    return (ctypes.c_longlong * 13)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                    *Cm.stride()[:2], *y.stride()[:3])


def launch_fma(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Launch the FMA kernel on checked CUDA arguments, whatever
    ``kernel_path`` says (``ssd_scan`` calls it on its "fma" path; timing
    scripts call it to hold the wgmma path against it). Not counted."""
    B, nh, S, hp = x.shape
    y = torch.empty_like(x)        # dense, in x's dim order: [B,S,nh,hp] for the model's views
    _check_rows("y", y)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fma_launch(x.data_ptr(), dt.data_ptr(), A.contiguous().data_ptr(),
                                      Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                      _strides(x, dt, Bm, Cm, y), B, nh, S, hp, Bm.shape[-1],
                                      build.dtype_code(x), build.stream_of(x))
    build.check(err, "ssd_scan (fma)")
    return y


def _launch_wgmma(x, dt, A, Bm, Cm, initial_state, return_state):
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    seg = segment_chunks(B, nh, S, build.sm_count(x.device.index or 0))
    nc = -(-S // KERNEL_CHUNK)
    n_seg = -(-nc // seg)
    f32 = dict(dtype=torch.float32, device=x.device)
    # scratch: C.B^T per (b, chunk); end state and log-decay of each segment but the last
    cb = torch.empty(B, nc, KERNEL_CHUNK * KERNEL_CHUNK, **f32)
    states = torch.empty(B, nh, max(n_seg - 1, 1), hp * N, **f32)
    seg_decay = torch.empty(B, nh, max(n_seg - 1, 1), **f32)
    init = None if initial_state is None else initial_state.contiguous()
    final = torch.empty(B, nh, hp, N, **f32) if return_state else None
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_wgmma_launch(
            x.data_ptr(), dt.data_ptr(), A.contiguous().data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), cb.data_ptr(), states.data_ptr(), seg_decay.data_ptr(),
            None if init is None else init.data_ptr(), None if final is None else final.data_ptr(),
            _strides(x, dt, Bm, Cm, y), B, nh, S, N, seg, build.stream_of(x))
    build.check(err, "ssd_scan (wgmma)")
    return y, final


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256, initial_state: torch.Tensor | None = None,
             return_state: bool = False):
    """x: [B,nh,S,hp]; dt: [B,nh,S] fp32 (softplus-ed); A: [nh] fp32
    (negative); Bm/Cm: [B,S,N] -> y [B,nh,S,hp] in x's dtype, and with
    ``return_state`` also the final state [B,nh,hp,N] fp32. The recurrence
    starts from ``initial_state`` (fp32 [B,nh,hp,N]) or zeros. On CUDA
    tensors both options need the wgmma path; elsewhere they raise.

    ``chunk`` sets the plain version's chunk length only: the kernels block
    by their own (64 tokens), and in exact arithmetic the result does not
    depend on it."""
    if _device_type(x) == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                            return_state=return_state)
    if _device_type(x) != "cuda":
        raise RuntimeError(f"ssd_scan runs on CUDA or CPU tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, Bm, Cm, initial_state)):
        raise RuntimeError("SSD backward not ported; ROADMAP queue 2 (ssd_scan on CUDA tensors "
                           "that require grad; run it under torch.no_grad() or on the CPU)")
    path = check_args(x, dt, A, Bm, Cm, initial_state, return_state)
    B, nh, S, hp = x.shape
    if B == 0 or S == 0:
        y = torch.empty_like(x)
        if not return_state:
            return y
        final = (initial_state.clone() if initial_state is not None else
                 torch.zeros(B, nh, hp, Bm.shape[-1], dtype=torch.float32, device=x.device))
        return y, final
    if path == "wgmma":
        y, final = _launch_wgmma(x, dt, A, Bm, Cm, initial_state, return_state)
    else:
        y, final = launch_fma(x, dt, A, Bm, Cm), None
    ssd_scan.launches += 1
    return (y, final) if return_state else y


ssd_scan.launches = 0
