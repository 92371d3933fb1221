#!/usr/bin/env python3
"""The SSD scan's backward kernel on one NVIDIA card, at mamba2-2.7b's
training shape.

    python3 scripts/ssd_bwd_probe.py [--quick]

Builds the kernels, prints the backward's registers, spills and shared
memory (``-Xptxas -v`` and the runtime), holds it against the plain
backward on ``chip_smoke.py``'s SSD backward cases and gates, then times
(median of 5 x 20 launches, CUDA events) the backward at x [1,80,2048,64],
N 128 in the model's layout, bf16 and fp32, beside its bound, the plain
backward and the forward, and its device time by launch (a) to (d)
(``torch.profiler``). ``--quick`` stops after the parity checks. Prints
the card's name and power limit. Imports no JAX.
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

from chip_smoke import (SSD_BWD_MAIN, _ssd_inputs, log, log_ssd_bwd_resources,  # noqa: E402
                        phase_ssd_bwd_parity, ssd_bwd_bound, time_device)

LAUNCHES = ("ssd_bwd_states", "ssd_bwd_dstates", "ssd_bwd_chunk", "ssd_bwd_sum_bc",
            "ssd_bwd_sum_da")


def times(gen):
    from repro_torch.kernels import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    B, nh, S, hp, N = SSD_BWD_MAIN
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = _ssd_inputs(gen, B, nh, S, hp, N, dtype, True, True)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        bound, by = ssd_bwd_bound(x, dt, A, Bm, Cm, dtype)
        ms = [time_device(lambda: ssd_scan_bwd(x, dt, A, Bm, Cm, dy)) for _ in range(2)]
        fwd = time_device(lambda: ssd_scan(x, dt, A, Bm, Cm))
        plain = time_device(lambda: ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy), n=3, reps=3)
        tag = str(dtype).replace("torch.", "")
        log(f"[time] ssd_scan_bwd {tag} x{list(x.shape)} N {N} views: {ms[0]:.4f}, {ms[1]:.4f} ms;"
            f" bound {bound:.4f} ms ({by}, {100 * bound / min(ms):.1f}%); plain {plain:.4f} ms;"
            f" forward {fwd:.4f} ms")
        kernel_split(lambda: ssd_scan_bwd(x, dt, A, Bm, Cm, dy), tag)


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
    phase_ssd_bwd_parity()
    if not args.quick:
        times(torch.Generator(device="cuda").manual_seed(5))
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
