#!/usr/bin/env python3
"""Digests of the wgmma SSD kernels' outputs on seeded inputs, on one card.

    python3 scripts/ssd_bits.py [--src DIR]

Runs the bf16 SSD forward at N 64 and 128 and the backward at N 16, 64 and
128 (``repro_torch.kernels.ssd_scan``), each at mamba2-2.7b's or
hymba-1.5b's shape in the model's layout and at a short padded one, with
and without the state options, and prints one sha256 of each output's
bytes. ``--src`` imports the package from another checkout's ``src``
directory (built there at first use), so two versions can be held bit for
bit: run once with each and compare the lines. Prints the card's name and
power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# B, nh, S, hp, N
FORWARD = [(2, 80, 2000, 64, 128), (2, 3, 500, 64, 64), (1, 5, 130, 64, 128)]
BACKWARD = [(1, 80, 2048, 64, 128), (1, 50, 2048, 64, 16), (2, 3, 500, 64, 64),
            (1, 5, 130, 64, 16)]


def inputs(seed, B, nh, S, hp, N):
    """x, B, C column slices of one bf16 [B,S,nh*hp+2N] buffer, dt a
    [B,nh,S] view of [B,S,nh] in the init's range, A in -[1, 16], a
    gradient dy in x's layout and fp32 states [B,nh,hp,N]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(B, S, nh * hp + 2 * N, generator=gen, device="cuda").bfloat16()
    x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    dt = (1e-3 + 0.099 * torch.rand(B, S, nh, generator=gen, device="cuda")).transpose(1, 2)
    A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda"))
    dy = torch.randn(B, S, nh, hp, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    h0, d_final = (torch.randn(B, nh, hp, N, generator=gen, device="cuda") for _ in range(2))
    return (x, dt, A, Bm, Cm), dy, h0, d_final


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"), help="the checkout's src directory")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("ssd_bits: no CUDA card available", file=sys.stderr)
        return 1
    from repro_torch.kernels import ssd_scan, ssd_scan_bwd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for seed, case in enumerate(FORWARD):
        inp, _, h0, _ = inputs(seed, *case)
        y = ssd_scan(*inp)
        y2, h = ssd_scan(*inp, initial_state=h0, return_state=True)
        print(f"forward {list(case)}: y {digest(y)}; with initial_state: y {digest(y2)} "
              f"final state {digest(h)}", flush=True)
    for seed, case in enumerate(BACKWARD):
        inp, dy, h0, d_final = inputs(100 + seed, *case)
        for state in (False, True):
            outs = ssd_scan_bwd(*inp, dy, h0 if state else None, d_final if state else None)
            print(f"backward {list(case)}{' with initial_state, d_final' if state else ''}: "
                  + " ".join(f"{n} {digest(o)}" for n, o in
                             zip(("dx", "ddt", "dA", "dBm", "dCm", "d_initial"), outs)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
