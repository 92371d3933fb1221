"""Batched chain replay of the simulator's co-design tier: the CUDA kernel
``csrc/chain_replay.cu`` for CUDA tensors, the plain
``ref.chain_replay_ref`` for CPU tensors.

One call runs one compiled chain program (``repro_torch.core.fastbatch``'s
``_Compiler``) for all G configurations of a signature group: one thread a
configuration, the leaf matrix V [rows, G] read a row at a time. It is the
op ``repro_torch::chain_replay`` (``build.define_op``), which counts a
launch in its CUDA implementation only. The byte counters ``accs`` [3, G]
are updated in place. ``depth``, the program's deepest par/spawn nesting,
picks the kernel's stack; past ``MAX_DEPTH`` the wrapper raises.

The kernel replaces the reference's numpy evaluator (``_BatchEval`` of
``repro.core.fastbatch``), not a Pallas kernel: the times must be the
strict left fold of the scalar tier, bit for bit, which a parallel scan
such as ``torch.cumsum`` does not keep.
"""

from __future__ import annotations

import torch

from . import build
from .ref import CHAIN_OPS, chain_replay_ref

__all__ = ["chain_replay", "check_args", "MAX_DEPTH", "CHAIN_OPS"]

MAX_DEPTH = 32          # the largest stack csrc/chain_replay.cu instantiates


def check_args(code, V, t, accs, entry, holds, spawns, depth) -> None:
    """Raise on what the kernel does not take. Looks at shapes, dtypes and
    devices only, so it runs on any device."""
    build.refuse_dtensor("chain_replay", code, V, t, accs)
    if code.dtype != torch.int32 or code.dim() != 1 or not code.is_contiguous():
        raise ValueError(f"chain_replay takes a contiguous 1-D int32 program, got "
                         f"{code.dtype} {tuple(code.shape)}")
    if V.dtype != torch.float64 or V.dim() != 2 or not V.is_contiguous():
        raise ValueError(f"chain_replay takes a contiguous fp64 leaf matrix [rows, G], got "
                         f"{V.dtype} {tuple(V.shape)}")
    G = V.shape[1]
    for name, x, shape in (("t", t, (G,)), ("accs", accs, (3, G))):
        if x.dtype != torch.float64 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"chain_replay takes a contiguous fp64 {name} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if any(x.device != V.device for x in (code, t, accs)):
        raise ValueError("chain_replay takes all its tensors on one device")
    if not 0 <= entry < code.shape[0]:
        raise ValueError(f"chain_replay entry {entry} is outside the program "
                         f"({code.shape[0]} words)")
    if holds < 0 or spawns < 0 or depth < 0:
        raise ValueError(f"chain_replay takes holds, spawns and depth >= 0, got "
                         f"{holds}, {spawns}, {depth}")
    if depth > MAX_DEPTH:
        raise ValueError(f"chain program nests par/spawn {depth} deep; the kernel's stack "
                         f"holds {MAX_DEPTH}")


def _outputs(V, holds, spawns):
    G = V.shape[1]
    return (V.new_empty(G), V.new_empty((holds, G)), V.new_empty((holds, G)),
            V.new_empty((spawns, G)))


def _run(code, V, t, accs, entry, holds, spawns, depth, launch):
    """The CUDA path on checked arguments: allocate, and with ``launch``
    run the kernel (one launch counted)."""
    check_args(code, V, t, accs, entry, holds, spawns, depth)
    out = _outputs(V, holds, spawns)
    if V.shape[1] == 0 or not launch:
        return out
    t_out, hold_start, hold_end, spawn_end = out
    lib = build.library()
    with torch.cuda.device(V.device):
        err = lib.chain_replay_launch(code.data_ptr(), entry, V.data_ptr(), V.shape[1],
                                      t.data_ptr(), t_out.data_ptr(), hold_start.data_ptr(),
                                      hold_end.data_ptr(), spawn_end.data_ptr(),
                                      accs.data_ptr(), depth, build.stream_of(V))
    build.check(err, "chain_replay")
    chain_replay.launches += 1
    return out


def _cpu(code, V, t, accs, entry, holds, spawns, depth):
    check_args(code, V, t, accs, entry, holds, spawns, depth)
    return chain_replay_ref(code, V, t, accs, entry, holds, spawns, depth)


_op = build.define_op(
    "chain_replay",
    "(Tensor code, Tensor V, Tensor t, Tensor(a!) accs, int entry, int holds, int spawns, "
    "int depth) -> (Tensor, Tensor, Tensor, Tensor)",
    cuda=lambda *a: _run(*a, launch=True), cpu=_cpu,
    fake=lambda *a: _run(*a, launch=False))


def chain_replay(code, V, t, accs, *, entry: int, holds: int, spawns: int, depth: int):
    """Run the program at ``code[entry:]`` (int32) over the leaf matrix ``V``
    [rows, G] (fp64) from the times ``t`` [G]: returns (end times [G], hold
    starts and ends [holds, G] in emission order, spawn ends [spawns, G])
    and adds the byte counters into ``accs`` [3, G] in place. CUDA tensors:
    the kernel, one launch counted; CPU tensors: ``ref.chain_replay_ref``."""
    return _op(code, V, t, accs, int(entry), int(holds), int(spawns), int(depth))


chain_replay.launches = 0
