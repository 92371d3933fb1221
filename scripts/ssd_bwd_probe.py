#!/usr/bin/env python3
"""The SSD scan's backward kernels on one NVIDIA card, at mamba2-2.7b's and
hymba-1.5b's training shapes.

    python3 scripts/ssd_bwd_probe.py [--quick] [--sweep] [--arch NAME ...]

Builds the kernels, prints the backwards' registers, spills and shared
memory (``-Xptxas -v`` and the runtime), holds both paths against the plain
backward on ``chip_smoke.py``'s SSD backward cases and gates, then times
(median of 5 x 20 launches, CUDA events) in the model's layout at each
``--arch``'s training shape (both by default): mamba2-2.7b's x
[1,80,2048,64], N 128, and hymba-1.5b's x [1,50,2048,64], N 16. There it
times the wgmma path (bf16) and the FMA kernel on the same inputs (bf16
and fp32), beside the bound, the plain backward and the forward, with each
path's device time by launch (``torch.profiler``) and the wgmma path's
scratch bytes. ``--sweep`` also times the wgmma path at each (chunks per
segment, heads per group) around ``bwd_plan``'s choice, the data
``bwd_plan``'s cost model is fitted to. ``--quick`` stops after the parity
checks. Prints the card's name and power limit. Imports no JAX.
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

from chip_smoke import (SSD_BWD_MAIN, SSD_BWD_N16, _ssd_inputs, log,  # noqa: E402
                        log_ssd_bwd_resources, log_ssd_bwd_wgmma_resources, phase_ssd_bwd_parity,
                        ssd_bwd_bound, time_device)

LAUNCHES = ("ssd_cb_kernel", "ssd_cb16_kernel", "ssd_bwd_segment_ends", "ssd_bwd_fold",
            "ssd_bwd_chunk_kernel", "ssd_bwd_sums", "ssd_bwd_states", "ssd_bwd_dstates",
            "ssd_bwd_chunk", "ssd_bwd_sum_bc", "ssd_bwd_sum_da")
SHAPES = {"mamba2-2.7b": SSD_BWD_MAIN, "hymba-1.5b": SSD_BWD_N16}
# the sweep's (chunks per segment, heads per group) grid at each shape
SWEEP = {"mamba2-2.7b": ((1, 2, 4, 8, 16, 32), (1, 2, 3, 4, 5, 8, 10, 16, 20)),
         "hymba-1.5b": ((1, 2, 3, 4, 6, 8, 11, 16, 32), (1, 2, 3, 4, 5, 7, 10, 13, 17, 25, 50))}


def times(gen, sweep, arch):
    from repro_torch.kernels import build, ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import (_bwd_outputs, _launch_bwd_wgmma, bwd_plan,
                                              bwd_scratch_bytes, launch_bwd_fma)
    B, nh, S, hp, N = SHAPES[arch]
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = _ssd_inputs(gen, B, nh, S, hp, N, dtype, True, True)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        bound, by = ssd_bwd_bound(x, dt, A, Bm, Cm, dtype)
        tag = str(dtype).replace("torch.", "")
        fwd = time_device(lambda: ssd_scan(x, dt, A, Bm, Cm))
        plain = time_device(lambda: ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy), n=3, reps=3)
        fma = lambda: launch_bwd_fma(x, dt, A, Bm, Cm, dy)
        runs = {"fma": fma}
        if dtype == torch.bfloat16:
            runs = {"wgmma": lambda: ssd_scan_bwd(x, dt, A, Bm, Cm, dy), "fma": fma}
        for name, fn in runs.items():
            ms = [time_device(fn) for _ in range(2)]
            log(f"[time] ssd_scan_bwd [{name}] {tag} x{list(x.shape)} N {N} views: {ms[0]:.4f}, "
                f"{ms[1]:.4f} ms; bound {bound:.4f} ms ({by}, {100 * bound / min(ms):.1f}%); "
                f"plain {plain:.4f} ms; forward {fwd:.4f} ms")
            kernel_split(fn, f"[{name}] {tag}")
        if dtype != torch.bfloat16:
            continue
        plan = bwd_plan(B, nh, S, build.sm_count(0), N)
        log(f"[plan] bwd_plan{(B, nh, S)} = (chunks per segment, heads per group) {plan}; "
            f"scratch {bwd_scratch_bytes(B, nh, S, N, *plan) / 1e6:.1f} MB; FMA path "
            f"{(4 * B * nh * S * N * 2 + 2 * 4 * B * nh * -(-S // 64) * hp * N) / 1e6:.1f} MB")
        if sweep:
            out = _bwd_outputs(x, dt, Bm)
            segs, groups = SWEEP[arch]
            for seg in segs:
                for group in groups:
                    fn = lambda: _launch_bwd_wgmma(x, dt, A, Bm, Cm, dy, None, None, out,
                                                   (seg, group))
                    ms = time_device(fn, n=10, reps=3)
                    log(f"[sweep] seg {seg} group {group}: {ms:.4f} ms, scratch "
                        f"{bwd_scratch_bytes(B, nh, S, N, seg, group) / 1e6:.1f} MB")


def kernel_split(fn, tag, calls=10):
    """Device time of each launch of ``fn`` (torch.profiler), per call."""
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
            name = next((k for k in LAUNCHES if k in e.name), e.name[:40])
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    log(f"[time] ssd_scan_bwd {tag} by launch (torch.profiler, us a call): " + ", ".join(
        f"{n} {us / calls:.2f}" for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA card available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="stop after the parity checks")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the wgmma path at each (segment length, head group)")
    ap.add_argument("--arch", nargs="+", default=list(SHAPES), choices=list(SHAPES),
                    help="the training shapes to time")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    path, seconds, out = build.build()
    build.library()
    log(f"[build] {path.name} nvcc {seconds:.2f} s")
    entry = ""
    for line in out.splitlines():     # -Xptxas -v: an entry line, then its resources
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "ssd_bwd" in entry and ("registers" in line or "spill" in line):
            log(f"[build] {entry[:60]}: {line.strip()}")
        elif "error" in line or "warning" in line:
            log(f"[build] {line.strip()}")
    log_ssd_bwd_resources()
    log_ssd_bwd_wgmma_resources()
    phase_ssd_bwd_parity()
    if not args.quick:
        for arch in args.arch:
            times(torch.Generator(device="cuda").manual_seed(5), args.sweep, arch)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
