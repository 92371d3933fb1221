#!/usr/bin/env python3
"""The backward kernels of flash attention and RMSNorm on one NVIDIA card,
at yi-6b's and nemotron-4-340b's training shapes.

    python3 scripts/flash_bwd_probe.py [--quick]

Builds the kernels, prints each kernel's registers, spills and shared
memory, holds the backward kernels and the forward's LSE against their
plain versions on a few shapes, hd 192 through ``chip_smoke.py``'s own
checks (``flash_hd192_parity``, ``flash_bwd_hd192_parity``), then times
(median of 5 x 20 launches, CUDA events), at q [1,32,2048,128] and
q [1,96,2048,192] in the model's views: the flash backward for each
number of GQA slices of the wgmma path (``flash_attention_bwd(...,
slices=...)``) beside SDPA's backward and its device time by kernel
(``torch.profiler``), the flash forward with and without the LSE; and
the RMSNorm backward at every width of its register version (H 1536,
1600, 2560, 3200, 4096, 5120) beside ``F.rms_norm``'s backward.
``--quick`` stops after the parity checks. Prints the card's name and
power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (FLASH_BWD_MAIN, FLASH_BWD_NEMOTRON, _bound, _bwd_gate,  # noqa: E402
                        _flash_bwd_case, _flash_inputs, _randn, flash_bwd_bound,
                        flash_bwd_hd192_parity, flash_hd192_parity, log, log_bwd_resources,
                        log_flash_resources, time_device)


def parity(gen):
    from repro_torch.kernels import rmsnorm_bwd
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        hds = (64, 128, 192) if dtype == torch.bfloat16 else (32, 192)
        for hd in hds:
            for B, S, nh, nkv, window in ((1, 1, 2, 2, 0), (2, 127, 4, 2, 0), (1, 200, 8, 1, 0),
                                          (1, 200, 4, 4, 37), (1, 2048, 25, 5, 1024),
                                          (1, 2048, 32, 4, 0)):
                _flash_bwd_case(f"flash_bwd {tag} hd={hd} B,S,nh,nkv=({B},{S},{nh},{nkv}) "
                                f"window={window}", *_flash_inputs(gen, B, S, nh, nkv, hd, dtype),
                                window)
        flash_hd192_parity(gen, dtype)
        flash_bwd_hd192_parity(gen, dtype)
        for T, H in ((7, 4096), (2048, 2560), (2048, 4096), (2048, 5120), (300, 1000),
                     (2048, 1536), (2048, 1600), (2048, 3200), (9, 1600), (1, 3200)):
            x, w, dy = (_randn(gen, T, H, dtype=dtype), _randn(gen, H, dtype=dtype),
                        _randn(gen, T, H, dtype=dtype))
            dx, dw = rmsnorm_bwd(x, w, dy)
            dx2, dw2 = rmsnorm_bwd(x, w, dy)
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                raise AssertionError(f"rmsnorm_bwd {tag} ({T},{H}): two calls differ")
            want = rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
            _bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dx", dx, want[0])
            _bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dw", dw[None], want[1][None])


def times(gen):
    from repro_torch.kernels import rmsnorm_bwd
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    dt = torch.bfloat16
    for B, S, nh, nkv, window, hd in (FLASH_BWD_MAIN, FLASH_BWD_NEMOTRON):
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_inputs(gen, B, S, nh, nkv, hd, dt))
        o, lse = flash_attention_fwd(q, k, v)
        do = _randn(gen, B, S, nh, hd, dtype=dt).transpose(1, 2)
        (bound, _), _ = flash_bwd_bound(q, k)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        sdpa = time_device(lambda: torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True))
        shape = f"q[{B},{nh},{S},{hd}] kv {nkv} heads"
        log(f"[time] SDPA backward {shape}: {sdpa:.4f} ms; bound {bound:.4f} ms")
        group = nh // nkv
        slices = [n for n in range(1, group + 1) if group % n == 0]
        for n in [*slices, 0, 0, *slices[::-1]]:
            ms = time_device(lambda: flash_attention_bwd(q, k, v, o, do, lse, slices=n))
            log(f"[time] flash_attention_bwd {shape} slices={n or 'auto'}: {ms:.4f} ms, "
                f"{100 * bound / ms:.1f}% of the bound, kernel / SDPA {ms / sdpa:.3f}")
        kernel_split(lambda: flash_attention_bwd(q, k, v, o, do, lse))
        for with_lse in (False, True, True, False):
            ms = time_device(lambda: flash_attention_fwd(q, k, v, lse=with_lse))
            log(f"[time] flash forward {shape} lse={with_lse}: {ms:.4f} ms")
    for H in (1536, 1600, 2560, 3200, 4096, 5120):
        T = 2048
        x, w, dy = _randn(gen, T, H, dtype=dt), _randn(gen, H, dtype=dt), _randn(gen, T, H, dtype=dt)
        bound, _ = _bound((3 * x.numel() + w.numel()) * x.element_size(), 10 * x.numel(),
                          torch.float32)
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        yl = F.rms_norm(xl, (H,), wl, eps=1e-5)
        lib = time_device(lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True))
        ms = [time_device(lambda: rmsnorm_bwd(x, w, dy)) for _ in range(2)]
        log(f"[time] rmsnorm_bwd x[{T},{H}]: {ms[0]:.4f}, {ms[1]:.4f} ms; F.rms_norm backward "
            f"{lib:.4f} ms; bound {bound:.4f} ms ({100 * bound / min(ms):.1f}%)")


def kernel_split(fn, calls=10):
    """Device time of each kernel of ``fn`` (torch.profiler), per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("delta", "dkdv", "dq", "sum") if f"flash_bwd_{k}" in e.name),
                        e.name[:40])
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    log("[time] flash_attention_bwd by kernel (torch.profiler, us a call): " + ", ".join(
        f"{n} {us / calls:.2f}" for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA card available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="stop after the parity checks")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    path, seconds, out = build.build()
    build.library()
    log(f"[build] {path.name} nvcc {seconds:.2f} s")
    for line in out.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "error" in line or "warning" in line):
            log(f"[build] {line.strip()}")
    log_flash_resources()
    log_bwd_resources()
    gen = torch.Generator(device="cuda").manual_seed(5)
    parity(gen)
    if not args.quick:
        times(gen)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
