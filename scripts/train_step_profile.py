#!/usr/bin/env python3
"""Where the time of one train step goes, on one NVIDIA card.

    python3 scripts/train_step_profile.py [--arch NAME] [--mesh]

Builds chip_smoke.py's training slice of ``--arch`` from chip_smoke.py's
own config (``TRAIN_LAYERS``: full-width yi-6b cut to 16 layers, the
default, mamba2-2.7b at all 64, hymba-1.5b or granite-moe-3b-a800m at all
32; fp32 masters and Adam moments, bf16 compute, G = 2 microbatches of 1
x 2048 tokens, remat off), runs one warm-up step, then 2
steps under ``torch.profiler``. Prints the host-clock step time, the
device time by kernel (grouped: the port's kernels, each ``flash_bwd_*``
and ``ssd_bwd_*`` launch of either SSD backward path, GEMMs, elementwise,
other), the share of the
step the device was idle, and the card's name and power limit. With
``--mesh`` the step is the FSDP x TP step on a one-card (1, 1) mesh over
NCCL (a one-rank process group), as ``chip_smoke.py``'s phase 7 runs it;
the NCCL kernels are a group of their own, and the host time of the
collectives' calls is printed. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# matched in order, lower case: the first key in a kernel's name names its group
# (names come demangled or mangled: the backward's C.B^T is ssd_cb_kernel<N, true>,
# ssd_cb16_kernel<true> at N 16; the forward's the same with false)
GROUPS = (("ssd_cb_kernel<128, true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernel<64, true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernelili128elb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernelili64elb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb16_kernel<true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb16_kernelilb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_bwd_segment_ends", "ssd bwd wgmma: segment ends"),
          ("ssd_bwd_fold", "ssd bwd wgmma: fold"),
          ("ssd_bwd_chunk_kernel", "ssd bwd wgmma: in-chunk gradients"),
          ("ssd_bwd_sums", "ssd bwd wgmma: group and dA sums"),
          ("ssd_bwd_states", "ssd bwd fma: (a) entering states"),
          ("ssd_bwd_dstates", "ssd bwd fma: (b) state gradients"),
          ("ssd_bwd_chunk", "ssd bwd fma: (c) in-chunk gradients"),
          ("ssd_bwd_sum", "ssd bwd fma: (d) partials' sums"),
          ("ssd_cb", "ssd forward wgmma: C.B^T"),
          ("ssd_segment_states", "ssd forward wgmma: segment states"),
          ("ssd_chunk_scan", "ssd forward wgmma: scan"),
          ("ssd_scan_kernel", "ssd forward fma"),
          ("ssd_", "ssd forward"),
          ("flash_bwd_delta", "flash bwd: D = rowsum(dO o)"), ("flash_bwd_dkdv", "flash bwd: dK dV"),
          ("flash_bwd_dq", "flash bwd: dQ"), ("flash_bwd_sum", "flash bwd: dK dV partials' sum"),
          ("flash_fwd", "flash forward"),
          ("flash_wgmma", "flash forward"),
          ("rmsnorm_bwd", "rmsnorm backward"), ("rmsnorm", "rmsnorm forward"),
          ("gemm", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
          ("nvjet", "GEMMs (cuBLAS)"), ("elementwise", "elementwise"),
          ("vectorized", "elementwise"), ("reduce", "reductions"),
          ("tensor_kernel_scan", "cumsum (MoE slots)"), ("index", "gather/scatter"),
          ("scatter", "gather/scatter"), ("sort", "gather/scatter"),
          ("nccl", "NCCL collectives"))
STEPS = 2


def group(name: str) -> str:
    low = name.lower()
    for key, label in GROUPS:
        if key in low:
            return label
    return "other"


def _one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="profile_pg_"), "store"), 1)
    dist.init_process_group("nccl", rank=0, world_size=1, store=store,
                            device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA card available", file=sys.stderr)
        return 1
    from chip_smoke import TRAIN_G, TRAIN_LAYERS, TRAIN_S, _train_arch, _train_cfg, _train_data
    from repro_torch.train.step import init_train_state, make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(TRAIN_LAYERS))
    ap.add_argument("--mesh", action="store_true",
                    help="the sharded step on a (1, 1) mesh over NCCL")
    args = ap.parse_args()
    arch, cfg = _train_arch(args.arch), _train_cfg()
    data = _train_data(arch)
    mesh = _one_rank_mesh() if args.mesh else None
    state = init_train_state(arch, cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                             mesh=mesh)
    step = make_train_step(arch, cfg, mesh)
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
    where = ", sharded on a (1, 1) mesh over NCCL" if mesh is not None else ""
    print(f"[profile] {args.arch} {arch.num_layers} layers{where}, G={TRAIN_G} x 1 x {TRAIN_S} "
          f"tokens, bf16, "
          f"remat off: {wall_ms:.2f} ms a step (host clock, under the profiler); device busy "
          f"{busy_ms:.2f} ms a step, idle share {100 * (1 - busy_ms / wall_ms):.1f}%")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {us / 1e3 / STEPS:.2f} ms a step "
              f"({100 * us / 1e3 / STEPS / wall_ms:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   {us / 1e3 / STEPS:9.3f} ms  {name[:110]}")
    if mesh is not None:
        host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(("c10d::", "nccl:"))]
        us = {}
        for e in host:
            us[e.name] = us.get(e.name, [0.0, 0])
            us[e.name][0] += e.time_range.elapsed_us()
            us[e.name][1] += 1
        for name, (t, n) in sorted(us.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"[profile] host {name}: {n // STEPS} calls, {t / 1e3 / STEPS:.2f} ms a step")
        torch.distributed.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
