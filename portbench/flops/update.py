"""The least bytes of a train step's update, from the leaves' sizes.

Whatever implements it (today ``train/optim.py:apply_optimizer``, then
``train/step.py:sync_model``), the update must read, for each parameter,
its master, its gradient accumulator and its two Adam moments, and write
the master, the moments and the compute copy the next forward reads:
each once, at the dtypes the configuration states. At fp32 masters,
moments and accumulator and a bf16 copy that is 30 bytes a parameter.
A kernel that folds the copy or the 1/G of the accumulation into the
update reads against the same count.
"""

from __future__ import annotations

from typing import Dict, Iterable

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def update_bytes(sizes: Iterable[int], dtypes: Dict[str, str]) -> int:
    """Bytes of one update over leaves of ``sizes`` elements. ``dtypes``
    names the ``masters``, ``grads`` (the accumulator the update reads),
    ``moments`` and ``compute`` types."""
    b = {k: ITEMSIZE[dtypes[k]] for k in ("masters", "grads", "moments", "compute")}
    per_param = 2 * b["masters"] + b["grads"] + 4 * b["moments"] + b["compute"]
    return per_param * sum(sizes)
