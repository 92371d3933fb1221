"""The one generator of inputs: every number a run feeds the port comes
from ``--seed`` through here, and the same seed gives the same inputs.

A traffic file holds parameters only; this module turns them into
batches and prompts. Token ids are drawn on the device with a
``torch.Generator`` of their own for each step or request, so a step's or
a request's tokens do not depend on how many came before it.
"""

from __future__ import annotations

import statistics
import zlib
from typing import Dict, List

import numpy as np
import torch


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed``."""
    words = [int(seed) % 2 ** 64] + [zlib.crc32(k.encode()) if isinstance(k, str) else int(k) % 2 ** 32
                                     for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *keys))


def train_batch(traffic: Dict, vocab: int, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: tokens and next-token labels [G, B, S], ids
    uniform over the vocabulary, every row fresh."""
    G, B, S = traffic["microbatches"], traffic["batch"], traffic["seq_len"]
    ids = torch.randint(0, vocab, (G, B, S + 1), generator=generator(device, seed, "batch", step),
                        device=device)
    return {"tokens": ids[..., :-1], "labels": ids[..., 1:]}


def length_table(lengths: Dict) -> List[int]:
    """The prompt lengths of one cycle, the same for every seed, so the
    tail repeats across seeds. ``fixed``: ``count`` prompts of ``length``.
    ``lognormal``: ``quantiles`` evenly spaced quantiles, at (i + 1/2) / n,
    of a log-normal of ``median`` and ``sigma``, rounded and clipped to
    [``min``, ``max``]."""
    if lengths["dist"] == "fixed":
        return [int(lengths["length"])] * int(lengths["count"])
    if lengths["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {lengths['dist']!r}")
    n, unit = lengths["quantiles"], statistics.NormalDist()
    table = []
    for i in range(n):
        z = unit.inv_cdf((i + 0.5) / n)
        L = round(lengths["median"] * float(np.exp(lengths["sigma"] * z)))
        table.append(min(max(L, lengths["min"]), lengths["max"]))
    return table


def cycle_order(n: int, seed: int, cycle: int) -> List[int]:
    """The order in which cycle ``cycle`` sends the table's lengths."""
    g = torch.Generator().manual_seed(subseed(seed, "order", cycle))
    return torch.randperm(n, generator=g).tolist()


def prompt(vocab: int, length: int, seed: int, cycle: int, index: int, device) -> torch.Tensor:
    """The token ids [1, length] of the ``index``-th request of ``cycle``."""
    return torch.randint(0, vocab, (1, length), generator=generator(device, seed, "prompt", cycle,
                                                                    index), device=device)
