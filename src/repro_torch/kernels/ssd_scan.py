"""Mamba2 SSD scan: a CUDA kernel for CUDA tensors, the plain
``ref.ssd_scan_ref`` for CPU tensors (ported from ``repro.kernels.ops``).

Two CUDA paths serve it, picked by (dtype, hp, N) in ``kernel_path``:
* ``"wgmma"``, ``csrc/ssd_scan.cu``: bf16 at hp 64 and N 16, 64 or 128
  (hymba-1.5b at N 16, mamba2-2.7b at 128). Three launches: C.B^T once per
  (b, chunk) for all heads, the end state of each segment of the sequence
  from a zero state, then the scan over (segment, h, b) with wgmma products
  and TMA copies (``segment_chunks`` picks the segment length). It also
  takes an ``initial_state`` and returns the final state on request.
* ``"fma"``, ``csrc/ssd_scan_fma.cu``: fp32 at every instantiated (hp, N),
  and bf16 at hp 16 or 32 and at hp 64 with N 32: one CTA per (b, h), fp32
  FMAs. ``launch_fma`` runs it whatever the path (timing and parity).
There is no fallback between them: a launch that fails raises.

``ssd_scan`` is differentiable in every input (``SSDScan``): its backward
is ``ssd_scan_bwd``, the plain ``ref.ssd_scan_bwd_ref`` on CPU tensors and
on CUDA tensors the kernel ``bwd_kernel_path`` names (one launch counted):
* ``"wgmma"``, ``csrc/ssd_scan_bwd_wgmma.cu``: bf16 at hp 64 and N 16, 64
  or 128 (the forward's wgmma shapes). Five launches: C.B^T and B.C^T once
  per (b, chunk), each segment's end state and end gradient from zero, their
  fold, the in-chunk gradients per (segment, head group, b) on wgmma with
  dB/dC summed over the group's heads in order, and the fixed-order sums
  over groups; ``bwd_plan`` picks the segment length and the group.
* ``"fma"``, ``csrc/ssd_scan_bwd.cu``: fp32 and every other bf16 shape,
  fp32 FMAs, four launches.
It saves the forward's inputs and recomputes the chunk states.

Both take strides, so x may be a [B,nh,S,hp] view of the model's
[B,S,nh,hp] tensor, Bm and Cm column slices of the conv output and dt a
[B,nh,S] view of a [B,S,nh] tensor: no copy in any case. y is allocated
in x's layout (dense, dims in x's stride order).

Forward and backward are the ops ``repro_torch::ssd_scan`` and
``repro_torch::ssd_scan_bwd`` (``build.define_op``: the launch for CUDA
tensors, the plain version for CPU tensors, the CUDA path's checks and
allocations, scratch included, for tensors without storage).
``fwd_flops`` and ``bwd_flops`` count their products, for
``FlopCounterMode`` and for the bounds in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "SSDScan", "check_args", "check_bwd_args", "kernel_path",
           "bwd_kernel_path", "segment_chunks", "bwd_plan", "launch_fma", "launch_bwd_fma",
           "HEAD_DIMS", "STATE_DIMS", "WGMMA_STATE_DIMS", "BWD_WGMMA_STATE_DIMS", "KERNEL_CHUNK",
           "SCAN_COST", "fwd_flops", "bwd_flops"]

HEAD_DIMS = (16, 32, 64)           # hp some kernel is instantiated for
STATE_DIMS = (16, 32, 64, 128)     # ... and N
WGMMA_STATE_DIMS = (16, 64, 128)   # N of the bf16 wgmma path (hp 64)
BWD_WGMMA_STATE_DIMS = (16, 64, 128)   # ... of the backward's
KERNEL_CHUNK = 64                  # tokens per chunk in the CUDA kernels


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


def _rows_ok(t) -> bool:
    """Unit stride along the last dim, rows 16-byte aligned (the FMA kernels
    stage rows in 16-byte vectors; TMA takes only such strides and bases)."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:-1])
            and build.address(t) % 16 == 0)


def _check_rows(name, t):
    build.refuse_dtensor("ssd_scan", t)
    if not _rows_ok(t):
        raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows, got "
                         f"strides {t.stride()} at address {build.address(t):#x}")


def _check_inputs(x, dt, A, Bm, Cm):
    """Shapes, dtypes and devices of the forward's inputs, which the
    backward takes too; returns (hp, N)."""
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
    kernel_path(x.dtype, hp, N)
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return hp, N


def _check_state(name, t, x, hp, N):
    B, nh = x.shape[:2]
    if t.shape != (B, nh, hp, N) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 [B,nh,hp,N] = {(B, nh, hp, N)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def check_args(x, dt, A, Bm, Cm, initial_state=None, return_state=False) -> str:
    """Raise on what the kernels do not take; return ``kernel_path``. Looks
    at shapes, dtypes, strides and addresses only (``build.address``), so
    it runs on any device."""
    hp, N = _check_inputs(x, dt, A, Bm, Cm)
    path = kernel_path(x.dtype, hp, N)
    if (initial_state is not None or return_state) and path != "wgmma":
        raise ValueError(f"initial_state / return_state are served by the wgmma path only "
                         f"(bf16, hp 64, N in {WGMMA_STATE_DIMS}), got {x.dtype}, hp {hp}, N {N}")
    if initial_state is not None:
        _check_state("initial_state", initial_state, x, hp, N)
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        _check_rows(name, t)
    return path


def bwd_kernel_path(dtype: torch.dtype, hp: int, N: int) -> str:
    """The backward kernel that serves (dtype, hp, N): ``"wgmma"``
    (``csrc/ssd_scan_bwd_wgmma.cu``) for bf16 at hp 64 and N in
    BWD_WGMMA_STATE_DIMS (the forward's wgmma shapes); ``"fma"``
    (``csrc/ssd_scan_bwd.cu``, fp32 FMAs) for fp32 and every other bf16
    (hp, N) in HEAD_DIMS x STATE_DIMS; raises elsewhere."""
    if hp not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"SSD backward kernel is instantiated for hp in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got hp {hp}, N {N}")
    if dtype == torch.bfloat16:
        return "wgmma" if hp == 64 and N in BWD_WGMMA_STATE_DIMS else "fma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"SSD backward kernel takes float32 or bfloat16, got {dtype}")


def check_bwd_args(x, dt, A, Bm, Cm, dy, initial_state=None, d_final=None) -> str:
    """Raise on what the backward kernel does not take; return
    ``bwd_kernel_path``. The forward's inputs as ``check_args`` takes them
    (the state options on every path), dy like x, and ``initial_state`` and
    ``d_final`` fp32 [B,nh,hp,N] or None. Runs on any device."""
    hp, N = _check_inputs(x, dt, A, Bm, Cm)
    path = bwd_kernel_path(x.dtype, hp, N)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device} like x, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    for name, t in (("initial_state", initial_state), ("d_final", d_final)):
        if t is not None:
            _check_state(name, t, x, hp, N)
    for name, t in (("x", x), ("dy", dy), ("Bm", Bm), ("Cm", Cm)):
        _check_rows(name, t)
    return path


def segment_chunks(B: int, nh: int, S: int, sms: int, N: int = 128) -> int:
    """Chunks per segment of the wgmma path at state width N. The scan runs
    B*nh*n_seg CTAs, ``SCAN_COST[N]["ctas"]`` to an SM, each over
    ceil(nc / n_seg) chunks, so its time goes as waves x chunks per
    segment; each segment past the first adds ``SCAN_COST[N]["segment"]``
    chunks' worth (its CTAs in the segment-state kernel, and a pass over
    its end state in every later segment). Takes the n_seg with the least
    such cost, the fewest segments on a tie. N 64/128 is fitted to a sweep
    at mamba2-2.7b prefill (B 2, nh 80, S 2000, 132 SMs; PERF.md): 3
    segments of 11 chunks, 480 CTAs; N 16 to sweeps at hymba-1.5b's prefill
    (B 2, nh 50, S 2000) and training (B 1, nh 50, S 2048) shapes."""
    nc = -(-S // KERNEL_CHUNK)
    ctas, extra = SCAN_COST[N]["ctas"], SCAN_COST[N]["segment"]
    best, best_cost = nc, None
    for n in range(1, nc + 1):
        seg = -(-nc // n)
        n_seg = -(-nc // seg)
        cost = -(-B * nh * n_seg // (ctas * sms)) * seg + extra * (n_seg - 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = seg, cost
    return best


# segment_chunks' cost model per N: the scan's CTAs an SM (its
# __launch_bounds__; chip_smoke.py checks the runtime fits as many) and the
# chunks' worth each segment past the first costs, fitted to the sweeps in
# PERF.md. At N 16 a segment costs less: its end state is 8 registers a
# thread to write and to fold, and its CTAs in the segment-state kernel
# share an SM seven at a time.
_SCAN_WIDE = {"ctas": 2, "segment": 2}
SCAN_COST = {128: _SCAN_WIDE, 64: _SCAN_WIDE, 16: {"ctas": 2, "segment": 0.5}}


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, nh: int, S: int, sms: int, N: int = 128) -> tuple[int, int]:
    """(chunks per segment, heads per group) of the wgmma backward, from a
    cost model in microseconds (``BWD_COST[N]``): its in-chunk kernel runs B
    * n_seg * n_groups CTAs, ``ctas`` to an SM, each over group x
    seg_chunks (chunk, head) items plus a forward step for each chunk of
    its segment but the last; the segment-ends kernel walks 2 (n_seg - 1)
    nh B segments, ``ends_ctas`` to an SM, at ``ends_step_us`` a chunk;
    each segment boundary moves four [hp, N] fp32 states a head (the
    segment-ends kernel writes two, the fold reads and writes them, the
    in-chunk kernel reads them), and each group's dB/dC partial is written
    and read once. Those bytes are charged at 1 TB/s, which trades some
    kernel time for scratch: at mamba2-2.7b's training shape (B 1, nh 80,
    S 2048, N 128, 132 SMs) the sweep in PERF.md read (4, 3) at 0.512 ms
    with 123 MB of scratch and per-head partials (4, 1) at 0.433 ms with
    289 MB; at hymba-1.5b's (B 1, nh 50, S 2048, N 16) it picks (4, 2),
    0.1143 ms in its sweep against the best plan's 0.1129 (8, 1). Takes the
    least cost; on a tie the larger group, then the fewer segments. Cached:
    the wrapper asks on every call."""
    nc = -(-S // KERNEL_CHUNK)
    cost_us = BWD_COST[N]
    item, step, rate = cost_us["item_us"], cost_us["step_us"], cost_us["bytes_per_us"]
    state = 4 * 64 * N
    best, best_key = None, None
    for seg in sorted({-(-nc // n) for n in range(1, nc + 1)}):
        n_seg = -(-nc // seg)
        ends = (8 * state * (n_seg - 1) * nh * B / rate
                + -(-2 * (n_seg - 1) * nh * B // (cost_us["ends_ctas"] * sms)) * seg
                * cost_us["ends_step_us"])
        for group in range(1, nh + 1):
            n_groups = -(-nh // group)
            if n_groups * group - nh >= group:
                continue
            waves = -(-B * n_seg * n_groups // (cost_us["ctas"] * sms))
            partials = 2 * n_groups * 2 * B * nc * KERNEL_CHUNK * N * 4 / rate
            cost = waves * group * (seg * item + (seg - 1) * step) + ends + partials
            key = (round(cost, 6), -group, n_seg)
            if best_key is None or key < best_key:
                best, best_key = (seg, group), key
    return best


# bwd_plan's cost model per N, each fitted to a sweep (PERF.md): one
# in-chunk (chunk, head) item and one forward state step in a CTA, the
# in-chunk CTAs an SM, the rate at which the plan's scratch bytes are
# charged, and a chunk of the segment-ends kernel with its CTAs an SM. At
# N 64 and 128 the segment-ends time is folded into the item (the fit to
# mamba2-2.7b's sweep); at N 16 an item is short and that kernel is not.
_COST_WIDE = {"item_us": 24.0, "step_us": 5.0, "ctas": 2, "bytes_per_us": 1.0e6,
              "ends_step_us": 0.0, "ends_ctas": 1}
BWD_COST = {128: _COST_WIDE, 64: _COST_WIDE,
            16: {"item_us": 10.0, "step_us": 2.0, "ctas": 2, "bytes_per_us": 1.0e6,
                 "ends_step_us": 2.0, "ends_ctas": 6}}


def _strides(x, dt, Bm, Cm, y):
    return (ctypes.c_longlong * 13)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                    *Cm.stride()[:2], *y.stride()[:3])


def launch_fma(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Launch the FMA kernel on checked CUDA arguments, whatever
    ``kernel_path`` says (``ssd_scan`` runs it on its "fma" path; timing
    scripts call it to hold the wgmma path against it). Not counted."""
    return _fma(x, dt, A, Bm, Cm, True)


def _fma(x, dt, A, Bm, Cm, launch):
    B, nh, S, hp = x.shape
    y = torch.empty_like(x)        # dense, in x's dim order: [B,S,nh,hp] for the model's views
    _check_rows("y", y)
    A = A.contiguous()
    if not launch:
        return y
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fma_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                      Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                      _strides(x, dt, Bm, Cm, y), B, nh, S, hp, Bm.shape[-1],
                                      build.dtype_code(x), build.stream_of(x))
    build.check(err, "ssd_scan (fma)")
    return y


def _wgmma(x, dt, A, Bm, Cm, initial_state, return_state, launch):
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    seg = segment_chunks(B, nh, S, build.sms_of(x), N)
    nc = -(-S // KERNEL_CHUNK)
    n_seg = -(-nc // seg)
    f32 = dict(dtype=torch.float32, device=x.device)
    # scratch: C.B^T per (b, chunk); end state and log-decay of each segment but the last
    cb = torch.empty(B, nc, KERNEL_CHUNK * KERNEL_CHUNK, **f32)
    states = torch.empty(B, nh, max(n_seg - 1, 1), hp * N, **f32)
    seg_decay = torch.empty(B, nh, max(n_seg - 1, 1), **f32)
    A = A.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    final = torch.empty(B, nh, hp, N, **f32) if return_state else None
    if not launch:
        return y, final
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_wgmma_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), cb.data_ptr(), states.data_ptr(), seg_decay.data_ptr(),
            None if init is None else init.data_ptr(), None if final is None else final.data_ptr(),
            _strides(x, dt, Bm, Cm, y), B, nh, S, N, seg, build.stream_of(x))
    build.check(err, "ssd_scan (wgmma)")
    return y, final


def _fwd(x, dt, A, Bm, Cm, initial_state, chunk, return_state, launch):
    """The CUDA forward on checked arguments: y, and the final state where
    ``return_state`` (else an empty tensor), with the ``kernel_path``
    kernel's scratch; with ``launch`` the kernel (one launch counted)."""
    path = check_args(x, dt, A, Bm, Cm, initial_state, return_state)
    B, nh, S, hp = x.shape
    none = x.new_empty(0, dtype=torch.float32)
    if B == 0 or S == 0:
        y = torch.empty_like(x)
        if not return_state:
            return y, none
        final = (initial_state.clone() if initial_state is not None else
                 torch.zeros(B, nh, hp, Bm.shape[-1], dtype=torch.float32, device=x.device))
        return y, final
    if path == "wgmma":
        y, final = _wgmma(x, dt, A, Bm, Cm, initial_state, return_state, launch)
    else:
        y, final = _fma(x, dt, A, Bm, Cm, launch), None
    if launch:
        ssd_scan.launches += 1
    return y, (final if return_state else none)


def _fwd_plain(x, dt, A, Bm, Cm, initial_state, chunk, return_state):
    """The plain forward, y in x's layout as the CUDA path allocates it."""
    out = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                       return_state=return_state)
    y, final = out if return_state else (out, x.new_empty(0, dtype=torch.float32))
    return torch.empty_like(x).copy_(y), final


_fwd_op = build.define_op(
    "ssd_scan",
    "(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, Tensor? initial_state, int chunk, "
    "bool return_state) -> (Tensor, Tensor)",
    cuda=lambda *a: _fwd(*a, launch=True), cpu=_fwd_plain, fake=lambda *a: _fwd(*a, launch=False))


def fwd_flops(B: int, nh: int, S: int, hp: int, N: int, Q: int = KERNEL_CHUNK) -> int:
    """The forward's products at chunk Q, with C.B^T shared across heads,
    per token: C.B^T 2QN; per head, scores x 2Q hp, chunk state 2 hp N,
    inter-chunk output 2 N hp."""
    return B * S * (2 * Q * N + nh * (2 * Q * hp + 4 * hp * N))


def bwd_flops(B: int, nh: int, S: int, hp: int, N: int) -> int:
    """The backward's products in the kernels' 64-token chunks: C.B^T per
    (b, chunk) and, per (b, h, chunk), dy.x^T and the dx, dB and dC
    products over the causal pairs, and per token the five [hp, N]
    products (the entering state, its gradient, dx's and dB's state terms,
    h_c^T dy)."""
    full, tail = divmod(S, KERNEL_CHUNK)
    pairs = full * KERNEL_CHUNK * (KERNEL_CHUNK + 1) // 2 + tail * (tail + 1) // 2
    return B * pairs * 2 * N + B * nh * (pairs * 2 * (2 * hp + 2 * N) + S * 5 * 2 * hp * N)


@register_flop_formula(_fwd_op)
def _fwd_op_flops(x, dt, A, Bm, Cm, initial_state, chunk, return_state, *, out_shape=None,
                  **kwargs) -> int:
    B, nh, S, hp = x
    return fwd_flops(B, nh, S, hp, Bm[-1])


def _bwd_strides(x, dt, Bm, Cm, dy, dx, ddt):
    return (ctypes.c_longlong * 19)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                    *Cm.stride()[:2], *dy.stride()[:3], *dx.stride()[:3],
                                    *ddt.stride())


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_bwd_fma(x, dt, A, Bm, Cm, dy, initial_state=None, d_final=None, out=None):
    """Launch the FMA backward on checked CUDA arguments with B, S > 0,
    whatever ``bwd_kernel_path`` says (``ssd_scan_bwd`` runs it on its
    "fma" path; timing scripts and chip_smoke.py call it to hold the wgmma
    path against it). Not counted. Returns (dx, ddt, dA, dBm, dCm,
    d_initial), or fills ``out``, a tuple of such tensors."""
    return _bwd_fma(x, dt, A, Bm, Cm, dy, initial_state, d_final, out, True)


def _bwd_fma(x, dt, A, Bm, Cm, dy, initial_state, d_final, out, launch):
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    dx, ddt, dA, dBm, dCm, d_initial = out if out is not None else _bwd_outputs(x, dt, Bm)
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = -(-S // KERNEL_CHUNK)
    # scratch: the state entering each chunk and the gradient of the state
    # leaving it; the per-head dB, dC and per-chunk dA partials
    states, dstates = (torch.empty(B, nh, nc, hp, N, **f32) for _ in range(2))
    dBp, dCp = (torch.empty(B, nh, S, N, **f32) for _ in range(2))
    dAp = torch.empty(B, nh, nc, **f32)
    A = A.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    fin = None if d_final is None else d_final.contiguous()
    if launch:
        lib = build.library()
        with torch.cuda.device(x.device):
            err = lib.ssd_scan_bwd_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                dy.data_ptr(), _ptr(init), _ptr(fin), states.data_ptr(), dstates.data_ptr(),
                dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), d_initial.data_ptr(),
                _bwd_strides(x, dt, Bm, Cm, dy, dx, ddt), B, nh, S, hp, N, build.dtype_code(x),
                build.stream_of(x))
        build.check(err, "ssd_scan_bwd (fma)")
    return dx, ddt, dA, dBm, dCm, d_initial


def bwd_scratch_bytes(B: int, nh: int, S: int, N: int, seg: int, group: int,
                      hp: int = 64) -> int:
    """fp32 scratch bytes of one wgmma backward call (``_launch_bwd_wgmma``)."""
    nc = -(-S // KERNEL_CHUNK)
    n_seg, n_groups = -(-nc // seg), -(-nh // group)
    floats = (B * nc * 2 * KERNEL_CHUNK ** 2 + B * nh * 2 * (n_seg - 1) * hp * N + B * nh * n_seg
              + B * n_groups * nc * hp * N + 2 * n_groups * B * nc * KERNEL_CHUNK * N
              + B * nh * nc)
    return 4 * floats


def _launch_bwd_wgmma(x, dt, A, Bm, Cm, dy, initial_state, d_final, out, plan=None,
                      launch=True):
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    dx, ddt, dA, dBm, dCm, d_initial = out
    seg, group = plan or bwd_plan(B, nh, S, build.sms_of(x), N)
    nc = -(-S // KERNEL_CHUNK)
    n_seg, n_groups = -(-nc // seg), -(-nh // group)
    f32 = dict(dtype=torch.float32, device=x.device)
    # scratch: C.B^T and B.C^T per (b, chunk); segment ends (then folded) and
    # log-decays; the state entering each chunk, per head group; the dB/dC
    # partial of each head group; the dA term of each (chunk, head)
    cb = torch.empty(B, nc, 2, KERNEL_CHUNK * KERNEL_CHUNK, **f32)
    ends = torch.empty(B, nh, 2, max(n_seg - 1, 1), hp * N, **f32)
    ld = torch.empty(B, nh, n_seg, **f32)
    stash = torch.empty(B, n_groups, nc, hp * N, **f32)
    part = torch.empty(2, n_groups, B, nc * KERNEL_CHUNK, N, **f32)
    dAp = torch.empty(B, nh, nc, **f32)
    A = A.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    fin = None if d_final is None else d_final.contiguous()
    if not launch:
        return
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_wgmma_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), _ptr(init), _ptr(fin), cb.data_ptr(), ends.data_ptr(), ld.data_ptr(),
            stash.data_ptr(), part.data_ptr(), dAp.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), d_initial.data_ptr(),
            _bwd_strides(x, dt, Bm, Cm, dy, dx, ddt), B, nh, S, N, seg, group,
            build.stream_of(x))
    build.check(err, "ssd_scan_bwd (wgmma)")


def _bwd_outputs(x, dt, Bm):
    """dx, ddt (dense, in x's / dt's dim order), dA, dBm, dCm (dense
    [B,S,N]) and d_initial, uninitialised."""
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dBm, dCm = (torch.empty(B, S, N, dtype=x.dtype, device=x.device) for _ in range(2))
    return dx, ddt, torch.empty(nh, **f32), dBm, dCm, torch.empty(B, nh, hp, N, **f32)


def _bwd(x, dt, A, Bm, Cm, dy, initial_state, d_final, chunk, launch):
    """The CUDA backward on checked arguments: the six outputs and the
    ``bwd_kernel_path`` kernel's scratch; with ``launch`` the kernel (one
    launch counted)."""
    path = check_bwd_args(x, dt, A, Bm, Cm, dy, initial_state, d_final)
    B, nh, S, hp = x.shape
    out = _bwd_outputs(x, dt, Bm)
    dx, ddt, dA, dBm, dCm, d_initial = out
    if B == 0 or S == 0:            # no token: the state passes through
        if d_final is None:
            d_initial.zero_()
        else:
            d_initial.copy_(d_final)
        return dx, ddt, dA.zero_(), dBm, dCm, d_initial
    _check_rows("dx", dx)
    if path == "wgmma":
        _launch_bwd_wgmma(x, dt, A, Bm, Cm, dy, initial_state, d_final, out, launch=launch)
    else:
        _bwd_fma(x, dt, A, Bm, Cm, dy, initial_state, d_final, out, launch)
    if launch:
        ssd_scan_bwd.launches += 1
    return out


def _bwd_plain(x, dt, A, Bm, Cm, dy, initial_state, d_final, chunk):
    """The plain backward, each gradient in the layout the CUDA path
    allocates (``_bwd_outputs``) and its input's type."""
    grads = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, initial_state, d_final, chunk=chunk)
    dx, ddt, dA, dBm, dCm, d_initial = grads
    return (torch.empty_like(x).copy_(dx), torch.empty_like(dt).copy_(ddt), dA,
            torch.empty(Bm.shape, dtype=Bm.dtype).copy_(dBm),
            torch.empty(Cm.shape, dtype=Cm.dtype).copy_(dCm), d_initial)


_bwd_op = build.define_op(
    "ssd_scan_bwd",
    "(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, Tensor dy, Tensor? initial_state, "
    "Tensor? d_final, int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cuda=lambda *a: _bwd(*a, launch=True), cpu=_bwd_plain,
    fake=lambda *a: _bwd(*a, launch=False))


@register_flop_formula(_bwd_op)
def _bwd_op_flops(x, dt, A, Bm, Cm, dy, initial_state, d_final, chunk, *, out_shape=None,
                  **kwargs) -> int:
    B, nh, S, hp = x
    return bwd_flops(B, nh, S, hp, Bm[-1])


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, initial_state=None, d_final=None, *, chunk: int = 256):
    """(the forward's inputs, dy = dL/dy [B,nh,S,hp], the forward's
    ``initial_state`` or None, d_final = dL/d(final state) or None) ->
    (dx, ddt, dA, dBm, dCm, d_initial): each in its input's type, dx in x's
    layout, ddt in dt's, dBm and dCm dense [B,S,N], d_initial fp32
    [B,nh,hp,N] (the gradient of the state the recurrence starts from).
    The op ``repro_torch::ssd_scan_bwd``. CPU tensors:
    ``ref.ssd_scan_bwd_ref`` (``chunk`` is its chunk length). CUDA tensors:
    the ``bwd_kernel_path`` kernel, ``csrc/ssd_scan_bwd_wgmma.cu`` (five
    launches) or ``csrc/ssd_scan_bwd.cu`` (four), one launch counted."""
    build.refuse_dtensor("ssd_scan_bwd", x, dt, A, Bm, Cm, dy, initial_state, d_final)
    return _bwd_op(x, dt, A, Bm, Cm, dy, initial_state, d_final, int(chunk))


class SSDScan(torch.autograd.Function):
    """The forward kernel, with ``ssd_scan_bwd`` as its gradient. Saves the
    forward's inputs (the backward recomputes the chunk states)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk, return_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        build.refuse_dtensor("ssd_scan", x, dt, A, Bm, Cm, initial_state)
        y, final = _fwd_op(x, dt, A, Bm, Cm, initial_state, int(chunk), bool(return_state))
        return (y, final) if return_state else y

    @staticmethod
    def backward(ctx, dy, d_final=None):
        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if dy.device.type != "cpu" and not _rows_ok(dy):
            dy = dy.contiguous()            # e.g. a broadcast gradient (stride 0)
        dx, ddt, dA, dBm, dCm, d_initial = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, initial_state,
                                                        d_final, chunk=ctx.chunk)
        return (dx, ddt, dA, dBm, dCm, None if initial_state is None else d_initial, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256, initial_state: torch.Tensor | None = None,
             return_state: bool = False):
    """x: [B,nh,S,hp]; dt: [B,nh,S] fp32 (softplus-ed); A: [nh] fp32
    (negative); Bm/Cm: [B,S,N] -> y [B,nh,S,hp] in x's dtype, and with
    ``return_state`` also the final state [B,nh,hp,N] fp32. The recurrence
    starts from ``initial_state`` (fp32 [B,nh,hp,N]) or zeros. On CUDA
    tensors both options need the wgmma path (bf16, hp 64, N in
    ``WGMMA_STATE_DIMS``); on the FMA path they raise.
    Differentiable in x, dt, A, Bm, Cm and the initial state
    (``SSDScan``).

    ``chunk`` sets the plain versions' chunk length only: the kernels block
    by their own (64 tokens), and in exact arithmetic the result does not
    depend on it."""
    return SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk, return_state)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
