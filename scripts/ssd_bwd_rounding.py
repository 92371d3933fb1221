#!/usr/bin/env python3
"""Where the wgmma SSD backward may round an operand to bf16 once, and where
it needs the pair hi + lo: a PyTorch emulation of its arithmetic.

    python3 scripts/ssd_bwd_rounding.py [--device cpu|cuda] [--S 1024] [--nh 4]

The emulation follows ``csrc/ssd_scan_bwd_wgmma.cu`` at a 64-token chunk:
products in fp32 from bf16 inputs, and each derived operand of a product
(the scores T, S1 and E dt; the state entering a chunk h_c; its gradient
dh; x o w and e^acs o dy of the two state walks) either as the pair hi + lo
(as the kernel feeds them) or rounded once, one group at a time. dx, dB
and dC are rounded to bf16 at the end, as the kernel stores them. Each
configuration is read against the plain backward in fp32
(``ref.ssd_scan_bwd_ref``) on the same bf16 inputs, with chip_smoke.py's
``_bwd_gate`` measures: relative L2 of the fp32 outputs (ddt, dA,
d_initial; limit 1e-4) and of the bf16 ones (limit 1e-2), their worst row
and the pointwise ratio (limit 1). Inputs: chip_smoke.py's long-memory draw
(dt ~ U(1e-3, 1e-1), A = -U(1, 16)) at hp 64, N 128, from a seed. Imports
no JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

GROUPS = ("scores", "h_c", "dh", "walks")


def bf16(t):
    return t.to(torch.bfloat16).float()


def pair(t):
    hi = bf16(t)
    return hi + bf16(t - hi)


def emulate(x, dt, A, Bm, Cm, dy, once=()):
    """The kernel's backward with the operand groups in ``once`` rounded to
    bf16 once and the others fed as pairs. Returns (dx, ddt, dA, dBm, dCm,
    d_initial) like ``ref.ssd_scan_bwd_ref``."""
    op = {g: (bf16 if g in once else pair) for g in GROUPS}
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    xc, dtc, Bc, Cc, acs = ref._ssd_chunks(x, dt, A, Bm, Cm, 64)
    nc, Q = dtc.shape[2:]
    dyc = F.pad(dy, (0, 0, 0, nc * Q - S)).reshape(B, nh, nc, Q, hp)
    L = ref._ssd_decay(acs)
    ea, el = torch.exp(acs), torch.exp(acs[..., -1:] - acs)
    w, decay = el * dtc, torch.exp(acs[..., -1])
    states = torch.einsum("bhcjp,bcjn->bhcpn", op["walks"](xc * w[..., None]), Bc)
    dy_c = torch.einsum("bhcip,bcin->bhcpn", op["walks"](dyc * ea[..., None]), Cc)
    h_prev, _ = ref._ssd_entering(states, decay, None)
    dh, d_initial = ref._ssd_leaving(dy_c, decay, None)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None]
    G = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc)
    T = op["scores"](G * L * dtc[..., None, :])
    S1 = op["scores"](cb * L * dtc[..., None, :])
    Fd = op["scores"](G * cb * L * dtc[..., None, :])
    hq, dq = op["h_c"](h_prev), op["dh"](dh)
    U = torch.einsum("bhcip,bhcpn->bhcin", dyc, hq)
    q = ea * (Cc[:, None] * U).sum(-1)
    dC = (ea[..., None] * U + torch.einsum("bhcij,bcjn->bhcin", T, Bc)).sum(1)
    V = torch.einsum("bhcjp,bhcpn->bhcjn", xc, dq)
    bv = (Bc[:, None] * V).sum(-1)
    dB = (w[..., None] * V + torch.einsum("bhcij,bcin->bhcjn", T, Cc)).sum(1)
    X2 = torch.einsum("bcjn,bhcpn->bhcjp", Bc, dq)
    dx = torch.einsum("bhcij,bhcip->bhcjp", S1, dyc) + w[..., None] * X2
    m = torch.arange(Q)
    V01 = (m[:, None] < m[None, :]).float()                    # [j, m]: j < m
    P = Fd @ V01                                               # sum_{j<m} E_ij dt_j
    straddle = (P * (m[:, None] >= m[None, :]).float()).sum(-2)
    col = (G * cb * L).sum(-2)
    suffix = torch.flip(torch.cumsum(torch.flip(q, [-1]), -1), [-1])
    prefix = F.pad(torch.cumsum(w * bv, -1)[..., :-1], (1, 0))
    da = straddle + suffix + prefix + (decay * (dh * h_prev).sum((-1, -2)))[..., None]
    ddt = col + el * bv + A[None, :, None, None] * da
    dA = (dtc * da).sum((0, 2, 3))
    dx = bf16(dx.reshape(B, nh, nc * Q, hp)[:, :, :S])
    dB, dC = (bf16(t.reshape(B, nc * Q, N)[:, :S]) for t in (dB, dC))
    return dx, ddt.reshape(B, nh, nc * Q)[:, :, :S], dA, dB, dC, d_initial


def readings(out, want):
    """chip_smoke.py:_bwd_gate's measures of ``out`` against ``want``."""
    err = out - want
    rel = (err.norm() / want.norm()).item()
    R, E = want.reshape(-1, want.shape[-1]), err.reshape(-1, want.shape[-1])
    rows = R.norm(dim=-1)
    typical = R.norm() / R.shape[0] ** 0.5
    limit = (2 ** -7 * R.abs() + 2 ** -6 * rows[:, None] / R.shape[-1] ** 0.5
             + 2 ** -6 * typical / R.shape[-1] ** 0.5)
    return rel, (E.norm(dim=-1) / (rows + 2 ** -6 * typical)).max().item(), \
        (E.abs() / limit).max().item()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--S", type=int, default=1024)
    ap.add_argument("--nh", type=int, default=4)
    args = ap.parse_args()
    dev, B, nh, S, hp, N = args.device, 1, args.nh, args.S, 64, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: bf16(torch.randn(*shape, generator=gen, device=dev))
    x, Bm, Cm, dy = rnd(B, nh, S, hp), rnd(B, S, N), rnd(B, S, N), rnd(B, nh, S, hp)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(B, nh, S, generator=gen, device=dev)
    A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device=dev))
    want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=64)
    names = ("dx", "ddt", "dA", "dBm", "dCm", "d_initial")
    print(f"x [{B},{nh},{S},{hp}], N {N}, long-memory draw, on {dev}; fp32 outputs: relative "
          f"L2 (limit 1e-4); bf16 outputs: relative L2, worst row, pointwise (limits 1e-2, "
          f"1e-2, 1)")
    for once in [()] + [(g,) for g in GROUPS]:
        got = emulate(x, dt, A, Bm, Cm, dy, once)
        parts = []
        for name, g, wnt in zip(names, got, want):
            if name == "dA":
                g, wnt = g[None], wnt[None]
            if name in ("dx", "dBm", "dCm"):
                parts.append(f"{name} " + "/".join(f"{v:.3e}" for v in readings(g, wnt)))
            else:
                parts.append(f"{name} {readings(g, wnt)[0]:.3e}")
        label = "all pairs (the kernel)" if not once else f"{once[0]} rounded once"
        print(f"{label}: " + ", ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
