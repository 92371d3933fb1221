"""Pieces every block family shares."""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-5          # RMSNorm's epsilon in both configurations


def fp32_only() -> None:
    """Keep every fp32 product in fp32: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class LowP:
    """The control's precision, fp8 where the port holds bf16: each operand
    and result of a matrix product, the scan's inputs and output and the
    residual stream are scaled by their largest magnitude to fp8 e4m3's
    range, rounded to e4m3 and scaled back; in the backward each gradient
    that passes such a point is rounded the same way. Norms, softmax, the
    loss and the optimizer stay fp32, as the port keeps them fp32."""

    dtype = torch.float8_e4m3fn
    top = 448.0

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x, self)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            scale = x.abs().amax().clamp_min(1e-30) / self.top
            return (x / scale).to(self.dtype).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lowp):
        ctx.lowp = lowp
        return lowp.q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.lowp.q(g), None


def op(x: torch.Tensor, lowp: Optional[LowP]) -> torch.Tensor:
    """A matrix product's operand at the run's precision."""
    return x if lowp is None else lowp.round(x)


def mm(a: torch.Tensor, b: torch.Tensor, lowp: Optional[LowP]) -> torch.Tensor:
    """A product whose operands and result are held at the run's precision."""
    return op(op(a, lowp) @ op(b, lowp), lowp)


def rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(x, threshold=1e9)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [S, n, hd] at ``positions`` [S], the halves
    rotated (Llama's ``rotate_half``)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
