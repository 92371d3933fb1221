#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card
     (the cases of tests/test_kernels.py and the main path's shapes; bf16
     outputs against the fp32 result of the same bf16 inputs; each path of
     a kernel that has two, such as the SSD scan's wgmma and FMA kernels);
  3. serve full-width yi-6b, then full-width mamba2-2.7b (random bf16
     weights from a seed), through the port's entry points: prefill B=2
     S=2000 with its kernel launches counted, the bf16 model's logits
     through the kernels against its logits through the plain versions, a
     teacher-forced forward/decode check, greedy generation and a few
     serve steps;
  4. after each model's path, time its kernels beside their bound, their
     plain version and one PyTorch library call where there is one, and
     time prefill and decode;
  5. hold the backward kernels (flash attention, RMSNorm) against their
     plain backwards (``kernels/ref.py``);
  6. train full-width yi-6b cut to 16 of its 32 layers (fp32 masters and
     Adam moments, bf16 compute, microbatch 1 x 2048 tokens, G = 2) through
     the port's entry points: gradients through the kernels against the
     plain versions (bf16 against fp32, fp32 at 2 layers against fp64),
     ``train_loop`` for 10 steps into a checkpoint and a restore that must
     give the saved state bit for bit, 10 ``make_train_step`` steps on one
     batch whose loss must fall, the first with its launches counted
     exactly, then the train step's time, tokens/s and peak memory and the
     backward kernels' times.
The last line is one JSON object with ``"ok": true`` and the device. It
needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense tensor core / fp32 FMA
TOL_F32 = dict(rtol=3e-4, atol=3e-4)                           # tests/test_kernels.py:16-18
# bf16 kernels against fp32 of the same bf16 inputs. Flash rounds p to
# bf16 for p v (l sums the fp32 p) and rounds o once: on random inputs
# that reads about 3e-3 relative L2 in the worst row and 0.65 of the
# pointwise limit. A 3% error on late kv tiles reads 3e-2 and 3.8; a
# dropped tile 1.0 and 130. The SSD FMA kernel keeps everything in fp32 and
# rounds y once (about 2^-9 of each); the SSD wgmma kernel rounds x o w to
# bf16 and P and h to bf16 pairs (hi + lo), and reads about 0.6 pointwise
# at mamba2's prefill shape; with h and P rounded once it read 4 to 7.
BF16_LIMITS = {"rel_l2": 1e-2, "row_rel_l2": 1e-2, "pointwise": 1.0}
# fp32 SSD kernel against the plain version: tests/test_kernels.py:56,
# plus relative L2 (the kernel chunks by 64, the plain version by 256).
SSD_F32_TOL, SSD_F32_REL_L2 = dict(rtol=2e-3, atol=2e-3), 1e-4
# bf16 RMSNorm against fp32 of the same inputs: one rounding, half a bf16
# ulp (2^-8 relative), plus fp32 reassociation.
RMS_BF16_RTOL = 1.01 * 2 ** -8
FLASH_CASES = [(1, 128, 4, 4, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 32), (2, 256, 6, 3, 128)]
FLASH_MAIN = (2, 2000, 32, 4, 128)       # yi-6b prefill: B, S, nh, nkv, hd
FLASH_HYMBA = (2, 2000, 25, 5, 64)       # hymba-1.5b prefill (window 1024)
RMS_CASES = [(64, 256), (100, 512), (256, 1024)]
# prefill B*S, teacher-forced S, decode B, prefill's final norm (B), teacher-forced decode
RMS_MAIN = [(4000, 4096), (64, 4096), (4, 4096), (2, 4096), (1, 4096)]
# B, nh, S, hp, N and the plain version's chunk (tests/test_kernels.py:40-44)
SSD_CASES = [(1, 2, 256, 64, 16, 128), (2, 3, 300, 32, 64, 64), (1, 4, 64, 16, 128, 32)]
SSD_MAIN = (2, 80, 2000, 64, 128, 256)   # mamba2-2.7b prefill
# the bf16 wgmma path (hp 64, N 64/128): B, nh, S, hp, N around its 64-token
# chunks and up to mamba2's prefill length, and the test grid's wgmma case
SSD_WGMMA_CASES = ([(2, 3, S, 64, N) for S in (1, 63, 65, 500, 2000) for N in (64, 128)]
                   + [(1, 5, 130, 64, 128)])
SSD_STATE_REL_L2 = 1e-2   # final state (fp32) of the wgmma path against the plain version
# mamba2-2.7b: prefill B*S, teacher-forced S, decode B, final norm B, teacher-forced decode
RMS_MAIN_SSM = [(4000, 2560), (4000, 5120), (300, 2560), (300, 5120), (4, 2560), (4, 5120),
                (2, 2560), (1, 2560), (1, 5120)]
# backward cases, B, S, nh, nkv, window (GQA groups 1, 2, 8; S 1, 127, 200,
# 2048; causal, one window), each at hd 32, 64 and 128; the training shape
FLASH_BWD_CASES = [(1, 1, 2, 2, 0), (2, 127, 4, 2, 0), (1, 200, 8, 1, 0), (1, 200, 4, 4, 37),
                   (1, 2048, 8, 1, 0)]
FLASH_BWD_MAIN = (1, 2048, 32, 4, 0, 128)      # yi-6b training: B, S, nh, nkv, window, hd
RMS_BWD_CASES = [(1, 256), (7, 4096), (300, 1000), (4096, 256), (4096, 4096), (33, 12288)]
RMS_BWD_MAIN = (2048, 4096)                    # yi-6b training, one microbatch
TRAIN_LAYERS, TRAIN_S, TRAIN_G = 16, 2048, 2   # yi-6b cut to fit one card (PERF.md)
TRAIN_STEPS = 10
SOURCES = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:87"),
           "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                   "src/repro/kernels/flash_attention.py:87"),
           "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:24"),
           "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                           "src/repro/kernels/rmsnorm.py:24"),
           "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:65")}


def log(*args):
    print(*args, flush=True)


def _launches(**counts):
    """Every kernel's launch count: those given, 0 for the rest."""
    from repro_torch import kernels
    return {name: counts.get(name, 0) for name in kernels.KERNELS}


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    path, seconds, out = build.build()
    build.library()
    log(f"[build] {path.name} nvcc {seconds:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    log_ssd_wgmma_resources()


def log_ssd_wgmma_resources():
    """Registers, spills (local memory), dynamic shared memory and CTAs an
    SM of the three wgmma SSD kernels, from the runtime; fails on a spill,
    or if two scan CTAs do not fit on an SM."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    for N in (64, 128):
        info = (ctypes.c_int * 12)()
        build.check(lib.ssd_scan_wgmma_info(N, info), "ssd_scan_wgmma_info")
        for k, name in enumerate(("ssd_cb", "ssd_segment_states", "ssd_chunk_scan")):
            regs, local, smem, ctas = info[4 * k:4 * k + 4]
            log(f"[build] {name}<N={N}>: {regs} registers, {local} bytes local (spills), "
                f"{smem} bytes dynamic shared memory, {ctas} CTAs an SM")
            if local:
                raise AssertionError(f"{name}<N={N}> spills {local} bytes a thread")
        if info[11] < 2:
            raise AssertionError(f"ssd_chunk_scan<N={N}>: {info[11]} CTA an SM, want 2")


# --------------------------------------------------------------------------
# 2. kernel parity on the card
# --------------------------------------------------------------------------

def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _flash_inputs(gen, B, S, nh, nkv, hd, dtype):
    return (_randn(gen, B, nh, S, hd, dtype=dtype), _randn(gen, B, nkv, S, hd, dtype=dtype),
            _randn(gen, B, nkv, S, hd, dtype=dtype))


def _compare_f32(name, out, ref):
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **TOL_F32, msg=lambda m: f"{name}: {m}")
    log(f"[parity] {name} max_abs_err={err:.3e} (allclose rtol=atol=3e-4) ok")
    return err


def _compare_bf16(name, out, ref):
    """out: a kernel's bf16 [B,nh,S,d] output; ref: the fp32 plain version
    on the same bf16 inputs. Gates the relative L2 error overall and of the
    worst row (b, h, s), and the worst ratio of |err| to
    2^-7 |ref| + 2^-6 rms(ref row)."""
    torch.cuda.synchronize()
    err = out.float() - ref
    row_err, row_ref = err.norm(dim=-1), ref.norm(dim=-1)
    row_rms = row_ref[..., None] / ref.shape[-1] ** 0.5
    got = {"rel_l2": (err.norm() / ref.norm()).item(),
           "row_rel_l2": (row_err / row_ref.clamp_min(1e-30)).max().item(),   # 0-rows must be 0
           "pointwise": (err.abs() / (2 ** -7 * ref.abs() + 2 ** -6 * row_rms)
                         .clamp_min(1e-30)).max().item()}
    max_abs = err.abs().max().item()
    reading = " ".join(f"{k}={v:.3e} (limit {BF16_LIMITS[k]:g})" for k, v in got.items())
    bad = [k for k, v in got.items() if not v <= BF16_LIMITS[k]]
    if bad:
        raise AssertionError(f"{name}: {reading}: over the limit in {bad}")
    log(f"[parity] {name} {reading} max_abs_err={max_abs:.3e} ok")
    return max_abs


def _compare_rms_bf16(name, out, ref):
    """out: the kernel's bf16 output; ref: fp32 RMSNorm of the same inputs."""
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    ratio = (err / (RMS_BF16_RTOL * ref.abs() + 1e-6)).max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |err| / (1.01 * 2^-8 |ref| + 1e-6) = {ratio:.3f} > 1")
    log(f"[parity] {name} |err|/(1.01*2^-8|ref|+1e-6)={ratio:.3f} (limit 1) "
        f"max_abs_err={err.max().item():.3e} ok")
    return err.max().item()


def _flash_case(name, q, k, v, window=0):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window)
    if q.dtype == torch.float32:
        return _compare_f32(name, out, ref)
    return _compare_bf16(name, out, ref)


def _ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory=False, views=False):
    """x [B,nh,S,hp], dt [B,nh,S] fp32, A [nh] fp32, Bm/Cm [B,S,N].
    tests/test_kernels.py's draw (dt = softplus(N(0,1)), A = -exp(N(0,1)/2))
    forgets within a few tokens; ``long_memory`` draws from the init's
    ranges (dt ~ U(1e-3, 1e-1), A = -U(1, 16)), so the state carried across
    chunks matters far past a chunk start. ``views`` lays the tensors out as
    the model does: x, Bm, Cm column slices of one [B,S,nh*hp+2N] buffer,
    dt a [B,nh,S] view of a [B,S,nh] tensor."""
    if views:
        buf = _randn(gen, B, S, nh * hp + 2 * N, dtype=dtype)
        x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
        Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    else:
        x = _randn(gen, B, nh, S, hp, dtype=dtype)
        Bm, Cm = _randn(gen, B, S, N, dtype=dtype), _randn(gen, B, S, N, dtype=dtype)
    shape = (B, S, nh) if views else (B, nh, S)
    if long_memory:
        dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(*shape, generator=gen, device="cuda")
        A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda"))
    else:
        dt = F.softplus(torch.randn(*shape, generator=gen, device="cuda"))
        A = -torch.exp(0.5 * torch.randn(nh, generator=gen, device="cuda"))
    return x, (dt.transpose(1, 2) if views else dt), A, Bm, Cm


def _ssd_case(name, chunk, x, dt, A, Bm, Cm, initial_state=None):
    """The kernel's y (and with ``initial_state`` its final state) against
    the plain version in fp32 on the same inputs."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    args = (x.float(), dt, A, Bm.float(), Cm.float())
    if initial_state is not None:
        out, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                          return_state=True)
        torch.cuda.synchronize()
        ref, h_ref = ssd_scan_ref(*args, chunk=chunk, initial_state=initial_state,
                                  return_state=True)
        rel = ((h - h_ref).norm() / h_ref.norm()).item()
        if not (torch.isfinite(h).all() and rel <= SSD_STATE_REL_L2):
            raise AssertionError(f"{name}: final state rel_l2={rel:.3e} > {SSD_STATE_REL_L2:g}")
        log(f"[parity] {name} final state rel_l2={rel:.3e} (limit {SSD_STATE_REL_L2:g}) ok")
        return _compare_bf16(name, out, ref)
    out = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    ref = ssd_scan_ref(*args, chunk=chunk)
    if x.dtype != torch.float32:
        return _compare_bf16(name, out, ref)
    rel = ((out - ref).norm() / ref.norm()).item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **SSD_F32_TOL, msg=lambda m: f"{name}: {m}")
    if not rel <= SSD_F32_REL_L2:
        raise AssertionError(f"{name}: rel_l2={rel:.3e} > {SSD_F32_REL_L2:g}")
    log(f"[parity] {name} rel_l2={rel:.3e} (limit {SSD_F32_REL_L2:g}) max_abs_err={err:.3e} "
        f"(allclose rtol=atol=2e-3) ok")
    return err


def phase_parity():
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for case in FLASH_CASES + [FLASH_MAIN]:
            for window in ((0, 96) if case != FLASH_MAIN else (0,)):
                err = _flash_case(f"flash {tag} B,S,nh,nkv,hd={case} window={window}",
                                  *_flash_inputs(gen, *case, dtype), window=window)
                if case == FLASH_MAIN:
                    errs[("flash_attention", dtype)] = err
        # the model's layout: [B,nh,S,hd] views of [B,S,nh,hd] tensors
        for case in ((2, 200, 4, 2, 64), FLASH_MAIN):
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in _flash_inputs(gen, *case, dtype))
            _flash_case(f"flash {tag} strided [B,S,nh,hd] views {case}", q, k, v)
        # rows past a short window and a padded tail: finite, no NaN
        q, k, v = _flash_inputs(gen, 1, 130, 2, 2, 64, dtype)
        _flash_case(f"flash {tag} window=3 S=130", q, k, v, window=3)
        # hymba-1.5b's attention (hd 64, GQA group 5, window 1024) at prefill
        _flash_case(f"flash {tag} B,S,nh,nkv,hd={FLASH_HYMBA} window=1024",
                    *_flash_inputs(gen, *FLASH_HYMBA, dtype), window=1024)
        # q based 16 bytes into a larger buffer: aligned for TMA, off the
        # 128-byte swizzle span
        q, k, v = _flash_inputs(gen, 2, 200, 4, 2, 128, dtype)
        q = torch.cat([q.new_zeros(16 // q.element_size()), q.flatten()])[16 // q.element_size():]
        _flash_case(f"flash {tag} q 16 bytes into a buffer", q.view(2, 4, 200, 128), k, v)
        for T, H in RMS_CASES + RMS_MAIN + RMS_MAIN_SSM:
            x, w = _randn(gen, T, H, dtype=dtype), _randn(gen, H, dtype=dtype)
            out = rmsnorm(x, w)
            torch.cuda.synchronize()
            ref = rmsnorm_ref(x.float(), w.float())
            name = f"rmsnorm {tag} T,H=({T},{H})"
            err = (_compare_f32(name, out, ref) if dtype == torch.float32
                   else _compare_rms_bf16(name, out, ref))
            if (T, H) == RMS_MAIN[0]:
                errs[("rmsnorm", dtype)] = err
        for B, nh, S, hp, N, chunk in SSD_CASES:
            for long_memory in (False, True):
                _ssd_case(f"ssd {tag} B,nh,S,hp,N=({B},{nh},{S},{hp},{N}) chunk={chunk}"
                          f"{' long-memory' if long_memory else ''}", chunk,
                          *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory))
        B, nh, S, hp, N, chunk = SSD_MAIN
        for long_memory in (False, True):
            for views in (False, True):
                err = _ssd_case(f"ssd {tag} main B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                                f"{' [B,S,.] views' if views else ''}"
                                f"{' long-memory' if long_memory else ''}", chunk,
                                *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory, views))
                if views and not long_memory:
                    errs[("ssd_scan", dtype)] = err
    # the bf16 wgmma path: its own cases, then the state options at the main
    # shape in the model's layout (the recurrence starts from a given state)
    from repro_torch.kernels.ssd_scan import kernel_path as ssd_path
    for B, nh, S, hp, N in SSD_WGMMA_CASES:
        assert ssd_path(torch.bfloat16, hp, N) == "wgmma"
        for long_memory in (False, True):
            _ssd_case(f"ssd wgmma bf16 B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                      f"{' long-memory' if long_memory else ''}", 256,
                      *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, long_memory))
    B, nh, S, hp, N, chunk = SSD_MAIN
    h0 = torch.randn(B, nh, hp, N, generator=gen, device="cuda")
    _ssd_case("ssd wgmma bf16 main [B,S,.] views long-memory, initial_state and return_state",
              chunk, *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, True, True),
              initial_state=h0)
    return errs


# --------------------------------------------------------------------------
# 3. full-width slice
# --------------------------------------------------------------------------

def _counts_since_reset(fn):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, kernels.launch_counts()


def _add(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain PyTorch versions
    (``repro_torch.models.layers`` looks the wrappers up on
    ``repro_torch.kernels`` at each call; ``KERNELS`` keeps the wrappers,
    whose counts must stay 0)."""
    from repro_torch import kernels
    saved = {name: getattr(kernels, name) for name in kernels.KERNELS}
    for name in saved:
        setattr(kernels, name, getattr(kernels.ref, f"{name}_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def _gap(a, b):
    """Relative L2 distance of logits a from b, and their argmax agreement."""
    return ((a - b).norm() / b.norm()).item(), (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def check_model_bf16(model, tokens, want):
    """The bf16 model's logits at every position of ``tokens``, through the
    kernels (launching ``want``) and through their plain versions, each
    against the same weights in fp32 through the plain versions. The
    kernels must land no further from fp32 than bf16 rounding puts the
    plain versions: relative L2 within 1.5x the plain gap, argmax agreement
    within 0.05 of it."""
    from repro_torch.models.lm import LM, RunCfg
    model32 = LM(model.arch, RunCfg(compute_dtype=torch.float32), device=model.device)
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        kern, counts = _counts_since_reset(lambda: model(tokens, logits_positions="all"))
        with plain_versions():
            plain, plain_counts = _counts_since_reset(
                lambda: model(tokens, logits_positions="all"))
            exact = model32(tokens, logits_positions="all")
    del model32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if counts != want or any(plain_counts.values()):
        raise AssertionError(f"launches: kernels {counts} (expected {want}), "
                             f"plain versions {plain_counts}")
    for name, t in (("kernels", kern), ("plain", plain), ("fp32", exact)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"model bf16 check: {name} logits not finite")
    (k_rel, k_agree), (p_rel, p_agree) = _gap(kern, exact), _gap(plain, exact)
    kp_rel, kp_agree = _gap(kern, plain)
    log(f"[slice] (c) bf16 logits B,S={tuple(tokens.shape)} vs fp32 weights-equal model: "
        f"kernels rel_l2={k_rel:.4g} argmax={k_agree:.4f}; plain rel_l2={p_rel:.4g} "
        f"argmax={p_agree:.4f}; kernels vs plain rel_l2={kp_rel:.4g} argmax={kp_agree:.4f}; "
        f"limits rel_l2<={1.5 * p_rel:.4g} argmax>={p_agree - 0.05:.4f}")
    if not (k_rel <= 1.5 * p_rel and k_agree >= p_agree - 0.05):
        raise AssertionError("bf16 logits through the kernels are further from fp32 than the "
                             "plain versions' rounding allows")


def _teacher_forced(model, tokens):
    """Logits [S,V] of one forward over ``tokens`` [1,S] and of S decode steps."""
    with torch.inference_mode():
        full = model(tokens, logits_positions="all")[0]
        cache = model.init_cache(1, tokens.shape[1])
        dec = torch.stack([model.decode_step(cache, tokens[:, t], t)[0]
                           for t in range(tokens.shape[1])])
    return full, dec


def _tf_summary(full, dec):
    err = (dec - full).abs()
    ratio = (err / (2e-2 + 2e-2 * full.abs())).max().item()
    rel = ((dec - full).norm() / full.norm()).item()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    return (f"max_abs_err={err.max().item():.4g} allclose(2e-2) ratio={ratio:.3g} "
            f"rel_l2={rel:.3g} argmax agreement={agree:.3f}")


def phase_slice(name, tf_len, tf_layers, total):
    """Serve full-width ``name`` through the port's entry points; adds the
    main path's launches to ``total``. The teacher-forced check runs
    ``tf_len`` tokens and is gated on the first ``tf_layers`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    from repro_torch.models.lm import RunCfg, init_params, param_count
    from repro_torch.serving.serve import greedy_generate, make_prefill_step, make_serve_step

    arch = scale_arch(get_config(name), "full")
    cfg = RunCfg(compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(arch, gen, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] {name} full width: {arch.num_layers} layers, d {arch.d_model}, "
        f"{param_count(model) / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.2f} s")
    V, L = arch.vocab, arch.num_layers
    ssm = arch.block == "ssm"
    norms = 2 * L + 1       # norm1 and norm2 (attn) or ssm_norm (ssm) per layer, final norm

    # (a), (b) prefill with its launches counted
    prefill = make_prefill_step(model)
    tokens = torch.randint(0, V, (2, 2000), generator=gen, device="cuda")
    logits, counts = _counts_since_reset(lambda: prefill({"tokens": tokens}))
    if logits.shape != (2, 1, V) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite [2,1,{V}]")
    want = _launches(flash_attention=0 if ssm else L, rmsnorm=norms, ssd_scan=L if ssm else 0)
    if counts != want:
        raise AssertionError(f"prefill launched {counts}, expected {want}")
    log(f"[slice] (a,b) {name} prefill B=2 S=2000: logits {tuple(logits.shape)} finite; "
        f"launches {counts}")
    _add(total, counts)

    # (c) the bf16 model through the kernels against the plain versions, at
    # the prefill's shape and in the model's layouts
    check_model_bf16(model, tokens, want)

    # (c) teacher-forced: forward over tf_len tokens vs tf_len decode steps
    # (tests/test_models.py:55-85). Gated in fp32 compute, where the 2e-2 of
    # that test applies. In bf16 the two paths round at different places
    # (kernels vs plain decode attention or recurrence, GEMMs of S rows vs
    # 1, the SSM leaves in bf16 in forward and fp32 in decode), and the
    # reference's init amplifies rounding (yi-6b: attention a hard argmax
    # over logits of std ~128), so there the numbers are only reported; the
    # check above gates bf16. mamba2 runs 300 tokens, past a 256-token chunk.
    tf_tokens = torch.randint(0, V, (1, tf_len), generator=gen, device="cuda")
    full, dec = _teacher_forced(model, tf_tokens)
    log(f"[slice] (c) {name} teacher-forced S={tf_len} bf16 (reported): {_tf_summary(full, dec)}")
    f32 = RunCfg(compute_dtype=torch.float32)
    model32 = init_params(arch, torch.Generator(device="cuda").manual_seed(0), f32, device="cuda")
    (full, dec), counts = _counts_since_reset(lambda: _teacher_forced(model32, tf_tokens))
    gated = tf_layers == L
    log(f"[slice] (c) {name} teacher-forced S={tf_len} fp32, {L} layers "
        f"({'gated' if gated else 'reported'}): {_tf_summary(full, dec)}; launches {counts}")
    if not gated:
        # Even fp32 rounding grows through mamba2's 64 layers under the
        # reference's init (a few percent of a logit at 64 layers); two
        # forwards that differ only in fp32 summation order show it. The
        # gate runs on the first tf_layers layers of the same weights.
        with torch.inference_mode(), plain_versions():
            plain = model32(tf_tokens, logits_positions="all")[0]
        log(f"[slice] (c) {name} fp32 forward, plain versions vs kernels, {L} layers "
            f"(reported): {_tf_summary(full, plain)}")
        model32.blocks = model32.blocks[:tf_layers]
        (full, dec), counts = _counts_since_reset(lambda: _teacher_forced(model32, tf_tokens))
        log(f"[slice] (c) {name} teacher-forced S={tf_len} fp32, first {tf_layers} layers "
            f"(gated): {_tf_summary(full, dec)}; launches {counts}")
    del model32
    torch.cuda.empty_cache()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("teacher-forced logits not finite")
    torch.testing.assert_close(dec, full, rtol=2e-2, atol=2e-2)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    if agree < 0.95:
        raise AssertionError(f"teacher-forced argmax agreement {agree:.3f} < 0.95")

    # (d) greedy generation
    prompt = torch.randint(0, V, (4, 32), generator=gen, device="cuda")
    out, counts = _counts_since_reset(lambda: greedy_generate(model, prompt, 32))
    _add(total, counts)
    if out.shape != (4, 32) or out.min() < 0 or out.max() >= V:
        raise AssertionError(f"greedy_generate gave {tuple(out.shape)} in [{out.min()}, {out.max()}]")
    log(f"[slice] (d) {name} greedy_generate B=4 prompt 32 new 32: tokens {tuple(out.shape)}; "
        f"launches {counts}")

    # (e) serve steps
    serve = make_serve_step(model)
    cache = model.init_cache(4, 8)

    def serve_steps():
        tok = prompt[:, 0]
        for pos in range(4):
            tok, lg, _ = serve(cache, tok, pos)
        return tok, lg

    (tok, lg), counts = _counts_since_reset(serve_steps)
    _add(total, counts)
    if lg.shape != (4, V) or not torch.isfinite(lg).all() or tok.shape != (4,):
        raise AssertionError("serve_step output malformed")
    if counts != _launches(rmsnorm=4 * norms):
        raise AssertionError(f"4 serve steps launched {counts}")
    log(f"[slice] (e) {name} 4 serve steps B=4: logits {tuple(lg.shape)} finite; "
        f"launches {counts}")
    return model, prefill, serve


# --------------------------------------------------------------------------
# 4. times
# --------------------------------------------------------------------------

def time_device(fn, n=20, reps=5):
    """Median device ms per call. A sleep kernel holds the card while the
    host queues all n calls, so host overhead does not leak in."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def _bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _log_row(r):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {lib}")


def _flash_row(gen, views):
    """Flash at yi-6b's prefill shape, bf16, beside SDPA on the same
    tensors: [B,nh,S,hd] tensors, or the model's [B,S,nh,hd] tensors seen
    through transposed views."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dt = torch.bfloat16
    B, S, nh, nkv, hd = FLASH_MAIN
    q, k, v = _flash_inputs(gen, B, S, nh, nkv, hd, dt)
    if views:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * nh * hd * S * (S + 1) // 2      # causal pairs this input needs
    bound, by = _bound(nbytes, flops, dt)
    row = dict(name="flash_attention", ms=time_device(lambda: flash_attention(q, k, v)),
               plain_ms=time_device(lambda: flash_attention_ref(q, k, v), n=3, reps=3),
               library_ms=time_device(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True)),
               bound_ms=bound, bound_by=by,
               shape=f"q{list(q.shape)} kv{list(k.shape)} bf16{' [B,S,nh,hd] views' if views else ''}")
    log(f"[time] flash_attention{' views' if views else ''}: {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * bound / row['ms']:.1f}% of the bound; SDPA {flops / row['library_ms'] / 1e9:.1f} "
        f"TFLOP/s; kernel / SDPA = {row['ms'] / row['library_ms']:.3f}")
    return row


def _rms_row(gen, T, H):
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref
    dt = torch.bfloat16
    x, w = _randn(gen, T, H, dtype=dt), _randn(gen, H, dtype=dt)
    bound, by = _bound((2 * x.numel() + w.numel()) * x.element_size(), 4 * x.numel(),
                       torch.float32)
    row = dict(name="rmsnorm", ms=time_device(lambda: rmsnorm(x, w)),
               plain_ms=time_device(lambda: rmsnorm_ref(x, w)),
               library_ms=time_device(lambda: F.rms_norm(x, (H,), w, eps=1e-5)),
               bound_ms=bound, bound_by=by, shape=f"x{list(x.shape)} bf16")
    log(f"[time] rmsnorm x[{T}, {H}]: {100 * bound / row['ms']:.1f}% of the bound; "
        f"kernel / F.rms_norm = {row['ms'] / row['library_ms']:.3f}")
    return row


def times_attn_kernels(gen):
    """yi-6b's kernels at its prefill shapes, bf16. The kernel line keeps
    the contiguous flash row and RMSNorm at [4000, 4096]; the strided flash
    row is logged."""
    rows = [_flash_row(gen, views=False)]
    _log_row(_flash_row(gen, views=True))
    rows.append(_rms_row(gen, *RMS_MAIN[0]))
    return rows


def times_ssm_kernels(gen):
    """The SSD kernel at mamba2-2.7b's prefill shape, in the model's layout:
    bf16 x, B, C as column slices of the conv output, fp32 dt. No single
    PyTorch call computes the scan, so there is no library time. The wgmma
    path is timed in turns with the FMA kernel that served this shape
    before it (FMA, wgmma, wgmma, FMA); the row keeps the mean of the two
    wgmma times. Also logs RMSNorm at mamba2's two prefill shapes (norm1
    and the gated ssm_norm), for the prefill breakdown; the kernel line
    keeps yi-6b's RMSNorm row."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import launch_fma
    for T, H in RMS_MAIN_SSM[:2]:
        _log_row(_rms_row(gen, T, H))
    B, nh, S, hp, N, Q = SSD_MAIN
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, views=True)
    # each input read once, y written once
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size())
    # the chunked algorithm's products at chunk Q with C.B^T shared across
    # heads, per token: C.B^T 2QN; per head, scores x 2Q hp, chunk state
    # 2 hp N, inter-chunk output 2 N hp
    flops = B * S * (2 * Q * N + nh * (2 * Q * hp + 4 * hp * N))
    bound, by = _bound(nbytes, flops, torch.bfloat16)
    turns = []
    for which in ("fma", "wgmma", "wgmma", "fma"):
        fn = (lambda: launch_fma(x, dt, A, Bm, Cm)) if which == "fma" else \
            (lambda: ssd_scan(x, dt, A, Bm, Cm))
        turns.append(time_device(fn))
    log(f"[time] ssd_scan in turns FMA, wgmma, wgmma, FMA: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms; wgmma {100 * bound / turns[1]:.1f}% and "
        f"{100 * bound / turns[2]:.1f}% of the bound; FMA / wgmma = "
        f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}")
    return [dict(name="ssd_scan", ms=(turns[1] + turns[2]) / 2,
                 plain_ms=time_device(lambda: ssd_scan_ref(x, dt, A, Bm, Cm), n=3, reps=3),
                 library_ms=None, bound_ms=bound, bound_by=by,
                 shape=f"x{list(x.shape)} B/C{list(Bm.shape)} bf16, dt fp32, views")]


def times_end_to_end(name, model, prefill, serve, gen, decode_spans):
    """Prefill B=2 S=2000, median of 3, and decode ms/token for B=4 over 32
    steps at each (cache span, first position) of ``decode_spans`` (host
    clock around synchronised work); peak memory over both."""
    tokens = torch.randint(0, model.arch.vocab, (2, 2000), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill({"tokens": tokens})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    dec = []
    for span, first in decode_spans:
        cache = model.init_cache(4, span)
        tok = tokens[:2].reshape(-1)[:4]
        serve(cache, tok, first - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(first, first + 32):
            tok, _, _ = serve(cache, tok, pos)
        torch.cuda.synchronize()
        dec.append(f"pos {first + 1}-{first + 32} {(time.perf_counter() - t0) * 1e3 / 32:.3f}")
        del cache
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {name} prefill B=2 S=2000: median {statistics.median(pre):.2f} ms of {pre}; "
        f"decode B=4 ms/token at {', '.join(dec)}; peak memory {peak:.2f} GiB")


# --------------------------------------------------------------------------
# 5. backward kernels against their plain backwards
# --------------------------------------------------------------------------

def _bwd_gate(name, out, ref, exact_zero_scale=None):
    """A backward kernel's output against the plain backward in fp32 on the
    same inputs; returns the max abs error. fp32: relative L2 within 1e-4.
    bf16 (fp32 of the same bf16 inputs): BF16_LIMITS, with each row's error
    taken against its norm plus 2^-6 of the typical row norm and the
    pointwise limit 2^-7 |ref| + 2^-6 rms(ref row) + 2^-6 rms(ref): rows
    whose exact gradient cancels to ~0 (the first causal row of dq) are
    rounding noise on both sides. ``exact_zero_scale``: the exact result is
    0 (dq, dk at S = 1: one live key, dS = P (dO.v - dO.o) with o = v), so
    |out| must stay below 1e-3 of that scale (max |dv|)."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: not finite")
    out32 = out.float()
    if exact_zero_scale is not None:
        got = out32.abs().max().item()
        if not got <= 1e-3 * exact_zero_scale:
            raise AssertionError(f"{name}: max |out| {got:.3e} > 1e-3 x {exact_zero_scale:.3e}")
        log(f"[bwd] {name} exact 0: max |out| {got:.3e} (limit {1e-3 * exact_zero_scale:.3e}) ok")
        return got
    err = out32 - ref
    max_abs = err.abs().max().item()
    rel = (err.norm() / ref.norm()).item()
    if out.dtype == torch.float32:
        if not rel <= 1e-4:
            raise AssertionError(f"{name}: rel_l2={rel:.3e} > 1e-4")
        log(f"[bwd] {name} rel_l2={rel:.3e} (limit 1e-4) max_abs_err={max_abs:.3e} ok")
        return max_abs
    R, E = ref.reshape(-1, ref.shape[-1]), err.reshape(-1, ref.shape[-1])
    rows = R.norm(dim=-1)
    typical = R.norm() / R.shape[0] ** 0.5
    limit = (2 ** -7 * R.abs() + 2 ** -6 * rows[:, None] / R.shape[-1] ** 0.5
             + 2 ** -6 * typical / R.shape[-1] ** 0.5)
    got = {"rel_l2": rel,
           "row_rel_l2": (E.norm(dim=-1) / (rows + 2 ** -6 * typical)).max().item(),
           "pointwise": (E.abs() / limit).max().item()}
    reading = " ".join(f"{k}={v:.3e} (limit {BF16_LIMITS[k]:g})" for k, v in got.items())
    bad = [k for k, v in got.items() if not v <= BF16_LIMITS[k]]
    if bad:
        raise AssertionError(f"{name}: {reading}: over the limit in {bad}")
    log(f"[bwd] {name} {reading} max_abs_err={max_abs:.3e} ok")
    return max_abs


def _flash_bwd_case(name, q, k, v, window, do=None):
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    o = flash_attention(q, k, v, causal=True, window=window)
    gen = torch.Generator(device="cuda").manual_seed(q.shape[2])
    if do is None:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = flash_attention_bwd(q, k, v, o, do, causal=True, window=window)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                   causal=True, window=window)
    errs = []
    for i, (part, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        zero = want[2].abs().max().item() if q.shape[2] == 1 and i < 2 else None
        errs.append(_bwd_gate(f"{name} {part}", g, w, exact_zero_scale=zero))
    return max(errs)


def phase_bwd_parity():
    """Each backward kernel against its plain backward (``kernels/ref.py``)
    on the same inputs: flash at hd 32/64/128, GQA groups 1, 2 and 8, S 1,
    127, 200 and 2048, causal and one window, the model's strided views and
    the training shape; RMSNorm at H 256, 1000, 4096, 12288 and T 1-4096."""
    from repro_torch.kernels import rmsnorm_bwd
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(17)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for hd in (32, 64, 128):
            for B, S, nh, nkv, window in FLASH_BWD_CASES:
                _flash_bwd_case(f"flash_bwd {tag} hd={hd} B,S,nh,nkv=({B},{S},{nh},{nkv}) "
                                f"window={window}", *_flash_inputs(gen, B, S, nh, nkv, hd, dtype),
                                window)
        B, S, nh, nkv, window, hd = FLASH_BWD_MAIN
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_inputs(gen, B, S, nh, nkv, hd, dtype))
        do = _randn(gen, B, S, nh, hd, dtype=dtype).transpose(1, 2)
        errs[("flash_attention_bwd", dtype)] = _flash_bwd_case(
            f"flash_bwd {tag} main {FLASH_BWD_MAIN[:4]} hd={hd} [B,S,nh,hd] views", q, k, v,
            window, do)
        for T, H in RMS_BWD_CASES + [RMS_BWD_MAIN]:
            x, w, dy = _randn(gen, T, H, dtype=dtype), _randn(gen, H, dtype=dtype), \
                _randn(gen, T, H, dtype=dtype)
            dx, dw = rmsnorm_bwd(x, w, dy)
            want = rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
            err = max(_bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dx", dx, want[0]),
                      _bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dw", dw[None], want[1][None]))
            if (T, H) == RMS_BWD_MAIN:
                errs[("rmsnorm_bwd", dtype)] = err
    return errs


# --------------------------------------------------------------------------
# 6. training slice: full-width yi-6b, 16 layers
# --------------------------------------------------------------------------

def _train_arch(layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("yi-6b"), num_layers=layers)


def _train_cfg(dtype=torch.bfloat16, remat=False):
    from repro_torch.models.lm import RunCfg
    from repro_torch.train.optim import OptimizerCfg
    from repro_torch.train.step import TrainCfg
    return TrainCfg(run=RunCfg(compute_dtype=dtype, remat=remat),
                    opt=OptimizerCfg(peak_lr=3e-4, warmup_steps=2, decay_steps=TRAIN_STEPS),
                    num_microbatches=TRAIN_G)


def _train_data(arch):
    from repro_torch.train.data import DataCfg, SyntheticDataset
    return SyntheticDataset(arch, DataCfg(seq_len=TRAIN_S, global_batch=TRAIN_G,
                                          num_microbatches=TRAIN_G, seed=0))


def _step_launches(layers):
    """Kernel launches of one train step, remat off: a flash forward and
    backward per layer, two RMSNorms and their backwards per layer plus the
    final norm, for each of the G microbatches."""
    return _launches(flash_attention=layers * TRAIN_G, flash_attention_bwd=layers * TRAIN_G,
                     rmsnorm=(2 * layers + 1) * TRAIN_G, rmsnorm_bwd=(2 * layers + 1) * TRAIN_G)


def _grads(model, batch, cfg, plain=False, remat=None):
    """(grads, loss, grad global norm, launches) of the G microbatches
    (``accumulate_grads``, the gradient half of the train step); with
    ``plain``, through the plain versions; ``remat`` overrides the model's."""
    import dataclasses
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import accumulate_grads
    saved = model.cfg
    if remat is not None:
        model.cfg = dataclasses.replace(saved, remat=remat)
    try:
        with plain_versions() if plain else contextlib.nullcontext():
            (grads, loss, _), counts = _counts_since_reset(
                lambda: accumulate_grads(model, batch, cfg))
    finally:
        model.cfg = saved
    return grads, loss.item(), global_norm(grads).item(), counts


def _rel_by_leaf(grads, ref):
    return {n: ((g.float() - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item()
            for n, g in grads.items()}


@torch.no_grad()
def _fan_in_h(model):
    """Rescale wq, wk, wv, wi and wg from the reference's std (1/L)^0.5 to
    (1/H)^0.5 (``lm._dense`` takes fan-in from the layer axis; ROADMAP §3)."""
    a = model.arch
    for blk in model.blocks:
        for p in (blk.attn["wq"], blk.attn["wk"], blk.attn["wv"], blk.mlp["wi"], blk.mlp["wg"]):
            p.mul_((a.num_layers / a.d_model) ** 0.5)
    return model


def _bf16_grads_vs_fp32(arch, batch, init):
    """bf16 gradients of G microbatches through the kernels and through the
    plain versions, each against fp32 of the same weights (plain versions,
    remat on); the kernels' launches gated exactly. Returns the readings."""
    from repro_torch.models.lm import LM, RunCfg, init_params
    model = init(init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                             RunCfg(compute_dtype=torch.bfloat16, remat=False), device="cuda"))
    model32 = LM(arch, RunCfg(compute_dtype=torch.float32), device="cuda")
    model32.load_state_dict(model.state_dict())
    g32, l32, n32, _ = _grads(model32, batch, _train_cfg(torch.float32), plain=True, remat=True)
    del model32
    torch.cuda.empty_cache()
    gk, lk, nk, counts = _grads(model, batch, _train_cfg())
    if counts != _step_launches(arch.num_layers):
        raise AssertionError(f"gradients launched {counts}, expected "
                             f"{_step_launches(arch.num_layers)}")
    rel_k = _rel_by_leaf(gk, g32)
    del gk
    gp, lp, np_, counts = _grads(model, batch, _train_cfg(), plain=True, remat=True)
    if any(counts.values()):
        raise AssertionError(f"plain versions launched {counts}")
    rel_p = _rel_by_leaf(gp, g32)
    del gp, g32, model
    torch.cuda.empty_cache()
    return dict(loss=(l32, lk, lp), norm=(n32, nk, np_), rel_k=rel_k, rel_p=rel_p)


def _fp32_grads_vs_fp64(arch, batch, init):
    """fp32 gradients through the kernels and through the plain versions,
    and fp64 gradients through the plain versions, of the same weights and
    batch: ((loss kernels, plain, fp64), (grad norms), (leaf relative L2 of
    kernels to plain, of kernels to fp64, of plain to fp64), (relative L2
    of the whole gradient of kernels to fp64, of plain to fp64))."""
    import dataclasses
    from repro_torch.models.lm import LM, RunCfg, init_params
    model = init(init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                             RunCfg(compute_dtype=torch.float32, remat=False), device="cuda"))
    cfg = _train_cfg(torch.float32)
    gk, lk, nk, _ = _grads(model, batch, cfg)
    gp, lp, np_, _ = _grads(model, batch, cfg, plain=True)
    model64 = LM(arch, RunCfg(compute_dtype=torch.float64, remat=False), device="cuda")
    model64.load_state_dict(model.state_dict())
    del model
    cfg64 = dataclasses.replace(_train_cfg(torch.float64), grad_accum_dtype=torch.float64)
    g64, l64, n64, _ = _grads(model64, batch, cfg64, plain=True)
    rels = (_rel_by_leaf(gk, gp), _rel_by_leaf(gk, g64), _rel_by_leaf(gp, g64))
    whole = tuple(math.sqrt(sum((r[n] * g64[n].norm().item()) ** 2 for n in r)) / n64
                  for r in rels[1:])
    del gk, gp, g64, model64
    torch.cuda.empty_cache()
    return (lk, lp, l64), (nk, np_, n64), rels, whole


def train_grads_gate():
    """(a) The gradients of the G microbatches (``accumulate_grads``, the
    train step's gradient half) through the kernels and through the plain
    versions from the same weights and batch, under two inits of the same
    seed: the reference's, and the same weights with wq, wk, wv, wi, wg at
    fan-in H (``_fan_in_h``). Under the reference's init attention is a
    hard argmax (logits of std ~250 at 16 layers, ~2000 at 2): dS = P (dP
    - D) cancels for the one live entry of a row, so gradients upstream of
    the scores turn on rounding, and two correct backwards (the kernels'
    FA2 form, autograd's softmax form) differ by percents even in fp32.
    bf16 at 16 layers: each route against fp32 of the same weights (plain
    versions): the kernels' distance to fp32 of the loss, the global norm
    and each leaf within 1.5x the plain versions' (or 1e-3 of the loss,
    1e-2 relative of a norm or leaf, where the plain versions land
    closer); gated on fan-in-H weights, reported on the reference's init.
    fp32 at 2 layers, both inits gated: each route against fp64 of the
    same weights (plain versions), the kernels' distance within 1.5x the
    plain versions' (or 1e-5 of the loss, 1e-4 relative L2 of the whole
    gradient or a leaf); the global norm of a gradient that is ~12%
    rounding noise moves by a few percent either way, so under the
    reference's init it is reported, and the whole gradient's distance
    gated. On fan-in-H weights also kernels against plain versions within
    1e-3 relative L2 for the norm and each leaf, 1e-5 for the loss."""
    arch = _train_arch(TRAIN_LAYERS)
    batch = _train_data(arch).batch_at(0)
    for name, init in (("reference init", lambda m: m), ("fan-in-H init", _fan_in_h)):
        r = _bf16_grads_vs_fp32(arch, batch, init)
        (l32, lk, lp), (n32, nk, np_), rel_k, rel_p = r["loss"], r["norm"], r["rel_k"], r["rel_p"]
        ratios = {n: rel_k[n] / max(rel_p[n], 1e-30) for n in rel_k}
        worst = sorted(ratios, key=ratios.get)[-3:]
        gated = name != "reference init"
        log(f"[train] (a) bf16 {TRAIN_LAYERS} layers, {name} ({'gated' if gated else 'reported'}),"
            f" G={TRAIN_G} x S={TRAIN_S}: loss fp32 {l32:.6f}, kernels {lk:.6f}, plain {lp:.6f}; "
            f"grad norm fp32 {n32:.6g}, kernels {nk:.6g}, plain {np_:.6g}; leaf rel_l2 to fp32: "
            f"kernels median {statistics.median(rel_k.values()):.4g} max "
            f"{max(rel_k.values()):.4g}, plain median {statistics.median(rel_p.values()):.4g} "
            f"max {max(rel_p.values()):.4g}; highest kernels/plain "
            + ", ".join(f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}" for n in worst))
        if not all(math.isfinite(x) for x in (l32, lk, lp, n32, nk, np_)):
            raise AssertionError(f"bf16 gradients ({name}): a loss or norm is not finite")
        if not gated:
            continue
        for what, k, p, floor in (("loss", abs(lk - l32), abs(lp - l32), 1e-3 * abs(l32)),
                                  ("grad norm", abs(nk - n32) / n32, abs(np_ - n32) / n32,
                                   1e-2)):
            if not k <= max(1.5 * p, floor):
                raise AssertionError(f"bf16 {what}: kernels {k:.4g} from fp32, plain {p:.4g}")
        bad = [n for n in rel_k if not rel_k[n] <= max(1.5 * rel_p[n], 1e-2)]
        if bad:
            raise AssertionError("bf16 gradients further from fp32 than the plain versions "
                                 "allow: " + ", ".join(f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}"
                                                        for n in bad))
    arch2 = _train_arch(2)
    batch2 = _train_data(arch2).batch_at(0)
    for name, init in (("reference init", lambda m: m), ("fan-in-H init", _fan_in_h)):
        (lk, lp, l64), (nk, np_, n64), (rel, rel_k, rel_p), (whole_k, whole_p) = \
            _fp32_grads_vs_fp64(arch2, batch2, init)
        ratios = {n: rel_k[n] / max(rel_p[n], 1e-30) for n in rel_k}
        worst = sorted(ratios, key=ratios.get)[-3:]
        log(f"[train] (a) fp32 2 layers, {name}: loss kernels {lk:.7f} plain {lp:.7f} fp64 "
            f"{l64:.7f}; grad norm kernels {nk:.7g} plain {np_:.7g} fp64 {n64:.7g}; whole "
            f"gradient rel_l2 to fp64 kernels {whole_k:.3e} plain {whole_p:.3e}; leaf rel_l2 "
            f"kernels to plain max {max(rel.values()):.3e} ({max(rel, key=rel.get)}) median "
            f"{statistics.median(rel.values()):.3e}; to fp64: kernels median "
            f"{statistics.median(rel_k.values()):.3e} max {max(rel_k.values()):.3e}, plain "
            f"median {statistics.median(rel_p.values()):.3e} max {max(rel_p.values()):.3e}; "
            f"highest kernels/plain " + ", ".join(f"{n} {rel_k[n]:.3e}/{rel_p[n]:.3e}"
                                                  for n in worst))
        for what, k, p, floor in (("loss", abs(lk - l64) / abs(l64), abs(lp - l64) / abs(l64),
                                   1e-5),
                                  ("whole gradient", whole_k, whole_p, 1e-4)):
            if not k <= max(1.5 * p, floor):
                raise AssertionError(f"fp32 {what} ({name}): kernels {k:.4g} from fp64, plain "
                                     f"{p:.4g}")
        bad = [n for n in rel_k if not rel_k[n] <= max(1.5 * rel_p[n], 1e-4)]
        if bad:
            raise AssertionError(f"fp32 gradients ({name}) further from fp64 than the plain "
                                 "versions allow: " + ", ".join(
                                     f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}" for n in bad))
        if name != "reference init" and not (abs(lk - lp) <= 1e-5 * abs(lp)
                                             and abs(nk - np_) <= 1e-3 * np_
                                             and max(rel.values()) <= 1e-3):
            raise AssertionError("fp32 gradients through the kernels differ from the plain "
                                 "versions")


def _check_against_checkpoint(state, ckpt_dir, step):
    """Every master, moment and the step of ``state`` equal, bit for bit,
    to the checkpoint of ``step`` in ``ckpt_dir`` (read a stacked leaf at a
    time)."""
    import numpy as np
    from repro_torch.convert import tree_path
    path = Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    leaves = {}
    for tree, named in (("params::", state.params), ("opt_state::m/", state.opt_state["m"]),
                        ("opt_state::v/", state.opt_state["v"])):
        for name, t in named.items():
            keys, layer = tree_path(name)
            leaves.setdefault(tree + "/".join(keys), []).append((layer, t))
    with np.load(path) as data:
        if int(data["opt_state::step"]) != int(state.opt_state["step"]):
            raise AssertionError("checkpoint step differs")
        for key, items in leaves.items():
            arr = data[key]
            for layer, t in items:
                a = torch.from_numpy(arr if layer is None else arr[layer]).to(t.device)
                if a.dtype != t.dtype or not torch.equal(a, t):
                    raise AssertionError(f"checkpoint {key} layer {layer} differs from the state")
    return len(leaves)


def train_loop_and_restore(total):
    """(b) ``train_loop`` for TRAIN_STEPS steps on the synthetic stream into
    a checkpoint directory, its launches gated exactly (and added to
    ``total``): finite losses and grad norms; the checkpoint equal to the
    state bit for bit; a second ``train_loop`` over the same directory
    restores it (running no step) to the same state bit for bit. Frees the
    state."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.data import DataCfg
    arch, cfg = _train_arch(TRAIN_LAYERS), _train_cfg()
    data = DataCfg(seq_len=TRAIN_S, global_batch=TRAIN_G, num_microbatches=TRAIN_G, seed=0)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        (state, losses, gnorms), counts = _counts_since_reset(lambda: train_loop(
            arch, cfg, data, TRAIN_STEPS, ckpt_dir=ckpt, log_every=1, ckpt_every=TRAIN_STEPS,
            log_fn=lambda m: log(f"[train] (b) {m}"), device="cuda"))
        seconds = time.perf_counter() - t0
        _add(total, counts)
        want = {k: n * TRAIN_STEPS for k, n in _step_launches(TRAIN_LAYERS).items()}
        if counts != want:
            raise AssertionError(f"train_loop launched {counts}, expected {want}")
        log(f"[train] (b) train_loop {TRAIN_STEPS} steps in {seconds:.1f} s (init, steps and a "
            f"checkpoint): losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 4) for x in gnorms]}; launches {counts}")
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError("train_loop: a loss or grad norm is not finite")
        t0 = time.perf_counter()
        n = _check_against_checkpoint(state, ckpt, TRAIN_STEPS)
        log(f"[train] (b) checkpoint step {TRAIN_STEPS}: {n} stacked leaves equal the state bit "
            f"for bit ({time.perf_counter() - t0:.1f} s)")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, losses, _ = train_loop(arch, cfg, data, TRAIN_STEPS, ckpt_dir=ckpt,
                                      log_fn=lambda m: log(f"[train] (b) {m}"), device="cuda")
        if losses:
            raise AssertionError(f"the resumed train_loop ran {len(losses)} steps, expected 0")
        _check_against_checkpoint(state, ckpt, TRAIN_STEPS)
        log(f"[train] (b) restored by train_loop in {time.perf_counter() - t0:.1f} s: equal "
            f"bit for bit")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()


def train_step_descent_and_times(total):
    """(c) ``make_train_step`` for TRAIN_STEPS steps on one fixed batch from
    a fresh train state (the seed of (b)), remat off: the first step's
    launches counted exactly (and added to ``total``); finite losses, the
    mean of the last 3 below the first; the steps after the first two
    timed (host clock around synchronised steps); peak memory over all of
    them. One batch, not the stream: a 4,096-token batch sees ~6% of the
    64,000-token vocabulary, so over 10 steps of fresh batches the loss
    only wanders by the batches' own spread (PERF.md); a fixed batch shows
    whether the steps descend."""
    from repro_torch.train.step import init_train_state, make_train_step
    arch, cfg = _train_arch(TRAIN_LAYERS), _train_cfg()
    batch = _train_data(arch).batch_at(0)
    state = init_train_state(arch, cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = make_train_step(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            (state, metrics), counts = _counts_since_reset(lambda: step(state, batch))
        else:
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            _add(total, counts)
            if counts != _step_launches(TRAIN_LAYERS):
                raise AssertionError(f"one train step launched {counts}, expected "
                                     f"{_step_launches(TRAIN_LAYERS)}")
            log(f"[train] (c) one train step, remat off, G={TRAIN_G}: launches {counts} (exact)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] (c) {TRAIN_STEPS} steps on one fixed batch: losses "
        f"{[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train step losses not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train step: loss did not fall ({losses})")
    med = statistics.median(ms[2:])
    log(f"[time] train step yi-6b {TRAIN_LAYERS} layers, G={TRAIN_G} x 1 x {TRAIN_S} tokens, "
        f"bf16 compute, fp32 masters and moments, remat off: median {med:.2f} ms of "
        f"{[round(x, 2) for x in ms[2:]]} (warm-up {ms[0]:.2f}, {ms[1]:.2f}); "
        f"{TRAIN_G * TRAIN_S / med * 1e3:.1f} tokens/s; peak memory {peak:.2f} GiB")


def times_train_kernels(gen):
    """The backward kernels at yi-6b's training shapes, bf16, beside their
    bound, their plain backward and the backward of one PyTorch call
    through autograd (SDPA with ``enable_gqa``, ``F.rms_norm``)."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, rmsnorm_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref, rmsnorm_bwd_ref
    dt = torch.bfloat16
    B, S, nh, nkv, window, hd = FLASH_BWD_MAIN
    q, k, v = _flash_inputs(gen, B, S, nh, nkv, hd, dt)
    o = flash_attention(q, k, v)
    do = _randn(gen, B, nh, S, hd, dtype=dt)
    # read q, k, v, o, dO, write dq, dk, dv; five products over the causal pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = 5 * 2 * B * nh * hd * S * (S + 1) // 2
    bound, by = _bound(nbytes, flops, dt)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    rows = [dict(name="flash_attention_bwd",
                 ms=time_device(lambda: flash_attention_bwd(q, k, v, o, do)),
                 plain_ms=time_device(lambda: flash_attention_bwd_ref(q, k, v, o, do), n=3, reps=3),
                 library_ms=time_device(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                                    retain_graph=True)),
                 bound_ms=bound, bound_by=by,
                 shape=f"q{list(q.shape)} kv{list(k.shape)} bf16 causal")]
    r = rows[0]
    log(f"[time] flash_attention_bwd: {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * bound / r['ms']:.1f}% of the bound; SDPA backward "
        f"{flops / r['library_ms'] / 1e9:.1f} TFLOP/s; kernel / SDPA = "
        f"{r['ms'] / r['library_ms']:.3f}")
    T, H = RMS_BWD_MAIN
    x, w, dy = _randn(gen, T, H, dtype=dt), _randn(gen, H, dtype=dt), _randn(gen, T, H, dtype=dt)
    bound, by = _bound((3 * x.numel() + w.numel()) * x.element_size(), 10 * x.numel(),
                       torch.float32)
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, eps=1e-5)
    rows.append(dict(name="rmsnorm_bwd", ms=time_device(lambda: rmsnorm_bwd(x, w, dy)),
                     plain_ms=time_device(lambda: rmsnorm_bwd_ref(x, w, dy)),
                     library_ms=time_device(lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                                        retain_graph=True)),
                     bound_ms=bound, bound_by=by, shape=f"x{list(x.shape)} bf16"))
    r = rows[1]
    log(f"[time] rmsnorm_bwd x[{T}, {H}]: {100 * bound / r['ms']:.1f}% of the bound; "
        f"kernel / F.rms_norm backward = {r['ms'] / r['library_ms']:.3f}")
    return rows


def phase_train(total):
    """Section 6: (a) gradients, (b) train_loop and restore, (c) descent on
    one batch, one step's launches and the step's time, then the backward
    kernels' times."""
    t0 = time.perf_counter()
    train_grads_gate()
    log(f"[train] (a) done in {time.perf_counter() - t0:.1f} s")
    train_loop_and_restore(total)
    train_step_descent_and_times(total)
    rows = times_train_kernels(torch.Generator(device="cuda").manual_seed(23))
    for r in rows:
        _log_row(r)
    return rows


def kernel_line(rows, errs, total):
    out = []
    for r in rows:
        src, replaces = SOURCES[r["name"]]
        out.append({"name": r["name"], "route": "cuda", "source": src, "replaces": replaces,
                    "launches": total[r["name"]], "max_abs_err": errs[(r["name"], torch.bfloat16)],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def run_model(name, tf_len, tf_layers, total, time_kernels, decode_spans):
    """One model's main path (launches added to ``total``), then its kernel
    and end-to-end times. Returns the kernel rows; frees the model."""
    model, prefill, serve = phase_slice(name, tf_len, tf_layers, total)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = time_kernels(gen)
    for r in rows:
        _log_row(r)
    times_end_to_end(name, model, prefill, serve, gen, decode_spans)
    del model, prefill, serve
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    errs = phase_parity()
    errs.update(phase_bwd_parity())
    total = {}
    # yi-6b: decode after a short prompt, and at the prefill's context in a
    # 2,048-token cache (decode attention reads pos + 1 slots)
    rows = run_model("yi-6b", 64, 32, total, times_attn_kernels, ((40, 1), (2048, 1984)))
    # mamba2-2.7b: decode cost does not depend on the context (a fixed state)
    rows += run_model("mamba2-2.7b", 300, 8, total, times_ssm_kernels, ((40, 1),))
    rows += phase_train(total)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"[slice] main-path launches, both models' serving and yi-6b's training {total}")
    kernels = kernel_line(rows, errs, total)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
