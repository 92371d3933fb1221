#!/usr/bin/env python3
"""Where the time of one train step goes, on one NVIDIA card.

    python3 scripts/train_step_profile.py

Builds chip_smoke.py's training slice from chip_smoke.py's own config
(full-width yi-6b cut to 16 layers, fp32 masters and Adam moments, bf16
compute, G = 2 microbatches of 1 x 2048 tokens, remat off), runs one
warm-up step, then 2 steps under ``torch.profiler``. Prints the
host-clock step time, the device time by kernel (grouped: the port's kernels, each
``flash_bwd_*`` launch, GEMMs, elementwise, other), the share of the step
the device was idle, and the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

GROUPS = (("flash_bwd_stats", "flash bwd: row statistics"), ("flash_bwd_dkdv", "flash bwd: dK dV"),
          ("flash_bwd_dq", "flash bwd: dQ"), ("flash_fwd", "flash forward"),
          ("flash_wgmma", "flash forward"),
          ("rmsnorm_bwd", "rmsnorm backward"), ("rmsnorm", "rmsnorm forward"),
          ("gemm", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
          ("nvjet", "GEMMs (cuBLAS)"), ("elementwise", "elementwise"),
          ("vectorized", "elementwise"), ("reduce", "reductions"), ("index", "gather/scatter"),
          ("scatter", "gather/scatter"), ("sort", "gather/scatter"))
STEPS = 2


def group(name: str) -> str:
    low = name.lower()
    for key, label in GROUPS:
        if key in low:
            return label
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA card available", file=sys.stderr)
        return 1
    from chip_smoke import TRAIN_G, TRAIN_LAYERS, TRAIN_S, _train_arch, _train_cfg, _train_data
    from repro_torch.train.step import init_train_state, make_train_step

    arch, cfg = _train_arch(TRAIN_LAYERS), _train_cfg()
    data = _train_data(arch)
    state = init_train_state(arch, cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = make_train_step(arch, cfg)
    state, _ = step(state, data.batch_at(0))
    torch.cuda.synchronize()
    batches = [data.batch_at(1 + i) for i in range(STEPS)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[group(e.name)] = by_group.get(group(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(by_group.values()) / 1e3 / STEPS
    print(f"[profile] yi-6b {TRAIN_LAYERS} layers, G={TRAIN_G} x 1 x {TRAIN_S} tokens, bf16, "
          f"remat off: {wall_ms:.2f} ms a step (host clock, under the profiler); device busy "
          f"{busy_ms:.2f} ms a step, idle share {100 * (1 - busy_ms / wall_ms):.1f}%")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {us / 1e3 / STEPS:.2f} ms a step "
              f"({100 * us / 1e3 / STEPS / wall_ms:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   {us / 1e3 / STEPS:9.3f} ms  {name[:110]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
