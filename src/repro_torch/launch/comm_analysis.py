"""Collective-communication accounting, the counterpart of
``repro.launch.hlo_analysis.collective_bytes``, which reads XLA's HLO text
and so has no torch form. ``CollectiveCounter`` is a dispatch mode that
sees every c10d collective a program issues, eager ones on a card as well
as those on tensors without storage over a "fake" process group, and sums
per kind the bytes of its result: the bytes this device receives (the
reference's convention): an all-gather's gathered tensor, an all-reduce's
reduced tensor, a reduce-scatter's shard, an all-to-all's exchanged
output, a receive's buffer (the pipeline's ``batch_isend_irecv``, counted
as "collective-permute"; a send receives nothing and is not counted). It
counts the calls of each kind beside the bytes.

The port issues the in-place c10d ops (``parallel/comm.py``: all-reduce,
all-gather into a tensor, reduce-scatter of a tensor;
``parallel/pipeline.py``: send and receive); DTensor's own redistributions
go through the functional collectives, which are counted the same way.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CollectiveCounter", "KINDS", "collective_kind"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# op name -> (kind, where its result is: "arg" for the in-place c10d ops,
# whose first argument is the output, "out" for the functional ones)
_OPS = {
    ("c10d", "allreduce_"): ("all-reduce", "arg"),
    ("c10d", "_allgather_base_"): ("all-gather", "arg"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "arg"),
    ("c10d", "alltoall_base_"): ("all-to-all", "arg"),
    ("c10d", "recv_"): ("collective-permute", "arg"),
    ("_c10d_functional", "all_reduce"): ("all-reduce", "out"),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "out"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "out"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "out"),
}


def collective_kind(func):
    """(kind, where) of a collective op overload, or None."""
    namespace, _, name = func.name().partition("::")
    return _OPS.get((namespace, name))


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(obj)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as c: ...``; then ``c.bytes`` and
    ``c.calls``, {kind: ...} over ``KINDS`` and "total". ``count`` takes
    one op's call, for a mode that counts collectives among other things
    (``launch.dryrun.StepMeter``)."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = dict.fromkeys((*KINDS, "total"), 0)
        self.calls: Dict[str, int] = dict.fromkeys((*KINDS, "total"), 0)
        self._kinds = {}

    def count(self, func, args, out) -> None:
        """Count ``func(*args) -> out`` if it is a collective."""
        found = self._kinds.get(func, False)
        if found is False:
            found = self._kinds[func] = collective_kind(func)
        if found is None:
            return
        kind, where = found
        n = _nbytes(args[0] if where == "arg" else out)
        for k in (kind, "total"):
            self.bytes[k] += n
            self.calls[k] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args, out)
        return out

    def record(self) -> Dict[str, Dict[str, int]]:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls)}
