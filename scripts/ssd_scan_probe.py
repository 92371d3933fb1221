#!/usr/bin/env python3
"""Probe the bf16 wgmma SSD scan on one card, at mamba2-2.7b's prefill
shape and hymba-1.5b's prefill and training shapes.

    python3 scripts/ssd_scan_probe.py [--arch NAME ...]

Builds the kernels and prints the wgmma SSD kernels' registers, spills,
shared memory and CTAs an SM (``chip_smoke.py``'s check), then, at each
``--arch``'s shapes (both archs by default): mamba2-2.7b's x
[2,80,2000,64], N 128, and hymba-1.5b's x [2,50,2000,64] and
[1,50,2048,64], N 16. The measurements behind the kernel's design choices
(PERF.md):
  1. where its error comes from (at the arch's first shape): the kernel,
     and a plain PyTorch emulation of its chunked algorithm (64-token
     chunks, fp32) that rounds each product operand (the scores P, the
     state h entering a chunk for C h^T, x o w for the state update) to
     bf16 once, to a bf16 pair (hi + lo), or not at all, each against the
     fp32 plain version, under the bf16 gate of chip_smoke.py (relative L2
     overall and of the worst row, pointwise ratio to 2^-7 |ref| + 2^-6
     rms(ref row));
  2. the scan's time against the segment length (chunks per segment), two
     passes, each length in turn, beside the FMA kernel on the same inputs
     and the length ``segment_chunks`` picks: the data its cost model
     (``SCAN_COST``) is fitted to;
  3. the device time of each of its three kernels (torch.profiler).
Inputs: x, B, C as column slices of one [B,S,nh*hp+2N] bf16 buffer and dt
a [B,nh,S] view of [B,S,nh], from seed 7. Prints the card's name and power
limit. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402  (its input maker, gate and timer)

# (B, nh, S, hp, N) of each arch: prefill first, then training
SHAPES = {"mamba2-2.7b": [(2, 80, 2000, 64, 128)],
          "hymba-1.5b": [(2, 50, 2000, 64, 16), (1, 50, 2048, 64, 16)]}
SEGMENTS = (32, 16, 11, 8, 7, 6, 5, 4, 3, 2, 1)
LAUNCHES = ("ssd_cb_kernel", "ssd_cb16_kernel", "ssd_segment_states_kernel",
            "ssd_chunk_scan_kernel")
Q = 64


def rounded(t, mode):
    """mode 0: fp32; 1: rounded once to bf16; 2: a bf16 pair hi + lo."""
    if mode == 0:
        return t
    hi = t.to(torch.bfloat16).float()
    return hi if mode == 1 else hi + (t - hi).to(torch.bfloat16).float()


def emulate(x, dt, A, Bm, Cm, r_p, r_h, r_xw):
    """The wgmma kernel's chunked algorithm in fp32 PyTorch, rounding P, h
    (for C h^T only; the recurrence stays fp32) and x o w as asked."""
    B, NH, S, HP = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S
    xc = F.pad(x.float(), (0, 0, 0, pad)).reshape(B, NH, nc, Q, HP)
    dtc = F.pad(dt.float(), (0, pad)).reshape(B, NH, nc, Q)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    acs = torch.cumsum(dtc * A[None, :, None, None], -1)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, float("-inf")))
    P = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None] * decay * dtc[..., None, :]
    y = torch.einsum("bhcij,bhcjp->bhcip", rounded(P, r_p), xc)
    del P, decay
    xw = xc * (torch.exp(acs[..., -1:] - acs) * dtc)[..., None]
    states = torch.einsum("bhcjp,bcjn->bhcpn", rounded(xw, r_xw), Bc)
    h = torch.zeros(B, NH, HP, N, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(rounded(h, r_h))
        h = h * torch.exp(acs[:, :, c, -1])[..., None, None] + states[:, :, c]
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cc, torch.stack(entering, 2)) * torch.exp(acs)[..., None]
    return y.reshape(B, NH, nc * Q, HP)[:, :, :S].to(torch.bfloat16)


def gate(out, ref):
    err = out.float() - ref
    row_rms = ref.norm(dim=-1, keepdim=True) / ref.shape[-1] ** 0.5
    return ((err.norm() / ref.norm()).item(),
            (err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item(),
            (err.abs() / (2 ** -7 * ref.abs() + 2 ** -6 * row_rms).clamp_min(1e-30)).max().item())


def errors(gen, case):
    """1. The kernel's and each emulation's error at ``case``, both draws."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    names = {0: "fp32", 1: "bf16", 2: "bf16 pair"}
    for long_memory in (False, True):
        x, dt, A, Bm, Cm = chip_smoke._ssd_inputs(gen, *case, torch.bfloat16, long_memory,
                                                  views=True)
        ref = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
        rows = [("kernel", ssd_scan(x, dt, A, Bm, Cm))]
        for r_p, r_h, r_xw in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1), (2, 2, 1)):
            rows.append((f"emulation P {names[r_p]}, h {names[r_h]}, x o w {names[r_xw]}",
                         emulate(x, dt, A, Bm, Cm, r_p, r_h, r_xw)))
        for name, out in rows:
            rel, row, point = gate(out, ref)
            print(f"[error] {list(case)} {'long-memory' if long_memory else 'default'} draw, "
                  f"{name}: rel_l2 {rel:.3e} worst row {row:.3e} pointwise {point:.3f}", flush=True)
        del ref, rows
        torch.cuda.empty_cache()


def segments_and_kernels(gen, case):
    """2. Time against the segment length beside the FMA kernel, and 3. the
    kernels' device times, at ``case``."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan import launch_fma
    mod = importlib.import_module("repro_torch.kernels.ssd_scan")
    B, nh, S, hp, N = case
    x, dt, A, Bm, Cm = chip_smoke._ssd_inputs(gen, *case, torch.bfloat16, views=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = mod.segment_chunks(B, nh, S, sms, N)
    bound, _ = chip_smoke.ssd_fwd_bound(x, dt, A, Bm, Cm, Q)
    print(f"[segments] {list(case)}: segment_chunks picks {chosen} chunks a segment; byte bound "
          f"{bound:.4f} ms", flush=True)
    nc = -(-S // Q)
    picker = mod.segment_chunks
    try:
        for rep in range(2):
            fma = chip_smoke.time_device(lambda: launch_fma(x, dt, A, Bm, Cm))
            print(f"[segments] {list(case)} pass {rep + 1}: FMA kernel {fma:.4f} ms", flush=True)
            for seg in sorted({min(s, nc) for s in SEGMENTS}, reverse=True):
                mod.segment_chunks = lambda *_, seg=seg: seg
                ms = chip_smoke.time_device(lambda: ssd_scan(x, dt, A, Bm, Cm))
                print(f"[segments] {list(case)} pass {rep + 1}: {seg} chunks a segment "
                      f"({-(-nc // seg)} segments): {ms:.4f} ms", flush=True)
    finally:
        mod.segment_chunks = picker
    from torch.profiler import ProfilerActivity, profile
    ssd_scan(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ssd_scan(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in LAUNCHES if k in e.name), e.name[:40])
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    print(f"[kernels] {list(case)} at {chosen} chunks a segment (torch.profiler, us a call): "
          + ", ".join(f"{n} {us / 20:.2f}" for n, us in sorted(by_name.items(),
                                                               key=lambda kv: -kv[1])),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_probe: no CUDA card available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(SHAPES), choices=list(SHAPES),
                    help="the shapes to probe")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    chip_smoke.log_ssd_wgmma_resources()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for arch in args.arch:
        errors(gen, SHAPES[arch][0])
        for case in SHAPES[arch]:
            segments_and_kernels(gen, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
