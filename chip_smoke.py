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
     time prefill and decode.
The last line is one JSON object with ``"ok": true`` and the device. It
needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
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
SOURCES = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:87"),
           "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:24"),
           "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:65")}


def log(*args):
    print(*args, flush=True)


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
    want = {"flash_attention": 0 if ssm else L, "rmsnorm": norms, "ssd_scan": L if ssm else 0}
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
    if counts != {"flash_attention": 0, "rmsnorm": 4 * norms, "ssd_scan": 0}:
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
    total = {}
    # yi-6b: decode after a short prompt, and at the prefill's context in a
    # 2,048-token cache (decode attention reads pos + 1 slots)
    rows = run_model("yi-6b", 64, 32, total, times_attn_kernels, ((40, 1), (2048, 1984)))
    # mamba2-2.7b: decode cost does not depend on the context (a fixed state)
    rows += run_model("mamba2-2.7b", 300, 8, total, times_ssm_kernels, ((40, 1),))
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"[slice] main-path launches, both models {total}")
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
