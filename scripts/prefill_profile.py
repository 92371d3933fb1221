#!/usr/bin/env python3
"""Where the time of one prefill goes, on one NVIDIA card.

    python3 scripts/prefill_profile.py [--arch NAME ...]

Builds each ``--arch`` at full width with random bf16 weights (seed 0),
as ``chip_smoke.py`` serves it, runs one warm-up prefill of B=2 S=2000
tokens, then one under ``torch.profiler``. Prints the host-clock prefill
time, the device time by kernel group (``train_step_profile.py``'s
groups) and the idle share, the heaviest kernels, and the card's name and
power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from train_step_profile import group  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_profile: no CUDA card available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.serving.serve import make_prefill_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["hymba-1.5b", "granite-moe-3b-a800m"])
    args = ap.parse_args()
    for name in args.arch:
        arch = get_config(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = init_params(arch, gen, RunCfg(compute_dtype=torch.bfloat16), device="cuda")
        prefill = make_prefill_step(model)
        tokens = torch.randint(0, arch.vocab, (2, 2000), generator=gen, device="cuda")
        prefill({"tokens": tokens})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill({"tokens": tokens})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_group, by_name = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            by_group[group(e.name)] = by_group.get(group(e.name), 0.0) + us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        busy_ms = sum(by_group.values()) / 1e3
        print(f"[profile] {name} prefill B=2 S=2000, bf16: {wall_ms:.2f} ms (host clock, under "
              f"the profiler); device busy {busy_ms:.2f} ms, idle share "
              f"{100 * (1 - busy_ms / wall_ms):.1f}%")
        for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"[profile] {label}: {us / 1e3:.2f} ms")
        for kernel, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[profile]   {us / 1e3:9.3f} ms  {kernel[:110]}")
        del model, prefill
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
