"""Rotary embedding of a layer's q and k: the CUDA kernel ``csrc/rope.cu``
for CUDA tensors, the plain ``ref.rope_ref`` for CPU tensors.

One launch rotates q [B,S,nh,hd] and k [B,S,nkv,hd] by the fp32 table
cos, sin [B,S,hd/2] (built by ``models.layers.rope_qk``), with the eager
version's arithmetic bit for bit, in bf16 and fp32. ``vector_path`` picks
16-byte vectors where hd/2 holds a whole number of them and every base is
16-byte aligned, single elements otherwise.

Forward and backward are one op, ``repro_torch_pointwise::rope``
(``build.define_op``: the launch for CUDA tensors, the plain versions for
CPU tensors, the CUDA path's checks and allocations for tensors without
storage), with a flag for the backward. It lives outside the
``repro_torch`` namespace, and its counters outside ``kernels.KERNELS``:
the benchmark's trace holds every ``repro_torch::`` op and every counted
kernel to a count from shapes, and reads this kernel as an eager op.

Gradients: ``rope`` is a ``torch.autograd.Function`` that saves the table;
its backward is ``rope_bwd``, the same kernel with the rotation reversed
(``ref.rope_bwd_ref`` on the CPU), bit for bit autograd's gradient of the
eager version.
"""

from __future__ import annotations

import torch

from . import build
from .ref import rope_bwd_ref, rope_ref

__all__ = ["rope", "rope_bwd", "check_args", "vector_path", "NAMESPACE"]

NAMESPACE = "repro_torch_pointwise"
VECTOR_BYTES = 16


def vector_path(q, k, cos, sin) -> bool:
    """Whether the kernel moves 16-byte vectors: hd/2 a multiple of 16 bytes
    of q's type and every base 16-byte aligned (``build.address``)."""
    half = q.shape[-1] // 2
    return (half * q.element_size() % VECTOR_BYTES == 0
            and all(build.address(t) % VECTOR_BYTES == 0 for t in (q, k, cos, sin)))


def check_args(q, k, cos, sin) -> bool:
    """Raise on what the kernel does not take; return ``vector_path``.
    Looks at shapes, dtypes, strides and addresses only, so it runs on any
    device."""
    build.refuse_dtensor("rope", q, k, cos, sin)
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"rope takes q [B,S,nh,hd] and k [B,S,nkv,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, _, hd = q.shape
    if hd % 2:
        raise ValueError(f"rope takes an even head dim, got {hd}")
    if cos.shape != (B, S, hd // 2) or sin.shape != cos.shape:
        raise ValueError(f"rope takes cos and sin [B,S,hd/2] = {(B, S, hd // 2)}, got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    build.dtype_code(q)
    if k.dtype != q.dtype or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"rope takes q and k of one type and an fp32 table, got {q.dtype}, "
                        f"{k.dtype}, {cos.dtype}, {sin.dtype}")
    if len({t.device for t in (q, k, cos, sin)}) != 1:
        raise ValueError("rope takes q, k, cos and sin on one device")
    if not all(t.is_contiguous() for t in (q, k, cos, sin)):
        raise ValueError("rope kernel takes contiguous q, k, cos and sin")
    return vector_path(q, k, cos, sin)


def _run(q, k, cos, sin, backward, launch):
    """The CUDA path on checked arguments: allocate the outputs, and with
    ``launch`` run the kernel (one launch counted, on ``rope_bwd`` for the
    backward)."""
    vec = check_args(q, k, cos, sin)
    B, S, nh, hd = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if B * S == 0 or not launch:
        return q_out, k_out
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.rope_launch(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                              q_out.data_ptr(), k_out.data_ptr(), B * S, nh, k.shape[2], hd,
                              build.dtype_code(q), int(vec), int(backward),
                              build.stream_of(q))
    build.check(err, "rope_bwd" if backward else "rope")
    (rope_bwd if backward else rope).launches += 1
    return q_out, k_out


def _cpu(q, k, cos, sin, backward):
    return (rope_bwd_ref if backward else rope_ref)(q, k, cos, sin)


_op = build.define_op(
    "rope", "(Tensor q, Tensor k, Tensor cos, Tensor sin, bool backward) -> (Tensor, Tensor)",
    cuda=lambda q, k, cos, sin, backward: _run(q, k, cos, sin, backward, True), cpu=_cpu,
    fake=lambda q, k, cos, sin, backward: _run(q, k, cos, sin, backward, False),
    namespace=NAMESPACE)


def rope_bwd(gq, gk, cos, sin):
    """(gq, gk, cos, sin) -> (dq, dk): the gradient of ``rope``. CUDA
    tensors: one launch, counted here; CPU tensors: ``ref.rope_bwd_ref``."""
    build.refuse_dtensor("rope_bwd", gq, gk, cos, sin)
    return _op(gq, gk, cos, sin, True)


class RoPE(torch.autograd.Function):
    """The forward kernel, with ``rope_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        build.refuse_dtensor("rope", q, k, cos, sin)
        return _op(q, k, cos, sin, False)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        if gq.device.type != "cpu":
            gq, gk = gq.contiguous(), gk.contiguous()
        dq, dk = rope_bwd(gq, gk, cos, sin)
        return dq, dk, None, None


def rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> tuple:
    """q [B,S,nh,hd], k [B,S,nkv,hd], cos and sin [B,S,hd/2] fp32 -> (q, k)
    rotated, in q's type. Differentiable in q and k (``RoPE``)."""
    return RoPE.apply(q, k, cos, sin)


rope.launches = 0
rope_bwd.launches = 0
