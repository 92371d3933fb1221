#!/usr/bin/env python3
"""Host-clock times of the port's train step and decode on one NVIDIA card,
for holding two checkouts against each other in one call.

    python3 scripts/step_times.py [--src DIR] [--mesh] [--decode]

Default: ``chip_smoke.py``'s yi-6b training slice (full width, 16 layers,
G = 2 x 1 x 2048 tokens, bf16 compute, fp32 masters, remat off), 2
warm-up steps then the median of 8 synchronised steps, and the peak
memory. ``--mesh``: the FSDP x TP step on a (1, 1) mesh over a one-rank
NCCL group, as ``chip_smoke.py``'s phase 7 runs it. ``--decode``: instead,
full-width yi-6b (32 layers, bf16 random weights) decoding B = 4 for 32
steps at positions 2-33 of a 40-slot cache, as ``chip_smoke.py`` times
it, the median ms/token of 5 such runs. ``--src`` imports the package
from another checkout's ``src`` (built there at first use); the
configuration comes from this checkout's ``chip_smoke.py``. Prints the
card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def train_step_ms(mesh_on: bool):
    from chip_smoke import _train_arch, _train_cfg, _train_data
    from repro_torch.train.step import init_train_state, make_train_step
    from train_step_profile import _one_rank_mesh
    arch, cfg = _train_arch("yi-6b"), _train_cfg()
    data = _train_data(arch)
    mesh = _one_rank_mesh() if mesh_on else None
    kw = {"mesh": mesh} if mesh_on else {}
    state = init_train_state(arch, cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", **kw)
    step = make_train_step(arch, cfg, mesh) if mesh_on else make_train_step(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(10):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms[2:], torch.cuda.max_memory_allocated() / 2**30


def decode_ms():
    from chip_smoke import _prompt
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.serving.serve import make_serve_step
    arch = get_config("yi-6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(arch, gen, RunCfg(compute_dtype=torch.bfloat16), device="cuda")
    serve = make_serve_step(model)
    tokens = _prompt(arch, gen, 4, 1).reshape(-1)
    ms = []
    for _ in range(5):
        cache = model.init_cache(4, 40)
        tok, _, _ = serve(cache, tokens, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(1, 33):
            tok, _, _ = serve(cache, tok, pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / 32)
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("step_times: no CUDA card available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--decode", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch  # noqa: F401  (from --src, before chip_smoke puts this checkout's first)
    sys.path.insert(1, str(ROOT))
    where = f"package from {args.src}"
    if args.decode:
        ms = decode_ms()
        print(f"[times] yi-6b decode B=4 at positions 2-33 ({where}): median "
              f"{statistics.median(ms):.2f} ms/token of {[round(x, 2) for x in ms]}")
    else:
        ms, peak = train_step_ms(args.mesh)
        kind = "sharded on a (1, 1) mesh over NCCL" if args.mesh else "one device"
        print(f"[times] yi-6b 16-layer train step, {kind} ({where}): median "
              f"{statistics.median(ms):.2f} ms of {[round(x, 2) for x in ms]}; peak {peak:.2f} GiB")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.mesh:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
