"""Collective *algorithm* schedules for the scale-out fabric.

Each algorithm compiles to a list of rounds; a round is a list of
``(src, dst, nbytes)`` point-to-point messages that run concurrently.
Members are abstract participant ids (the fabric model passes chip ids),
so the schedules are topology-agnostic — the model prices each message
over the fabric route and executes rounds as barriers of link-holding
transfer events (or closed forms, per fidelity mode).

Algorithms (ASTRA-sim-style menu):

* ``ring``       — all kinds; ``2(p-1)`` steps of ``n/p`` for all-reduce,
  ``p-1`` steps for reduce-scatter / all-gather.
* ``tree``       — binomial reduce + broadcast; ``2*ceil(log2 p)`` rounds
  of full-size messages for all-reduce (latency-optimal: wins for small
  messages at high participant counts).
* ``hd``         — recursive halving-doubling reduce-scatter /
  all-gather (``log2 p`` rounds, payload halving/doubling); non-power-of-2
  groups fall back to ring.
* ``pairwise``   — all-to-all: ``p-1`` rounds, each member exchanging an
  ``n/p`` shard with one distinct peer (MoE dispatch).

``alpha_beta_lower_bound`` gives the bandwidth-term lower bound the tests
cross-check simulated costs against (ring all-reduce: ``2(p-1)/p * n/bw``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "ring_rounds",
    "tree_rounds",
    "hd_rounds",
    "pairwise_rounds",
    "rounds_for",
    "alpha_beta_lower_bound",
]

# (src, dst, nbytes) messages; one round's messages run concurrently
Message = Tuple[int, int, float]
Rounds = List[List[Message]]


def _steps(kind: str, p: int) -> int:
    return {"all_reduce": 2 * (p - 1), "reduce_scatter": p - 1,
            "all_gather": p - 1, "all_to_all": p - 1}[kind]


def ring_rounds(members: Sequence[int], kind: str, nbytes: float) -> Rounds:
    """Ring schedule: every step, member i sends an ``n/p`` chunk to its
    ring successor (all-reduce = reduce-scatter pass + all-gather pass)."""
    m = list(members)
    p = len(m)
    if p <= 1 or nbytes <= 0:
        return []
    chunk = nbytes / p
    return [[(m[i], m[(i + 1) % p], chunk) for i in range(p)]
            for _ in range(_steps(kind, p))]


def tree_rounds(members: Sequence[int], kind: str, nbytes: float,
                root: Optional[int] = None) -> Rounds:
    """Binomial-tree schedule: ``ceil(log2 p)`` rounds of full-size
    messages for reduce or broadcast, both passes for all-reduce."""
    m = list(members)
    p = len(m)
    if p <= 1 or nbytes <= 0:
        return []
    if root is not None and root in m:
        m.remove(root)
        m = [root] + m
    depth = (p - 1).bit_length()

    def reduce_pass() -> Rounds:
        rounds: Rounds = []
        for r in range(depth):
            step = [(m[i], m[i - (1 << r)], nbytes)
                    for i in range(p) if i % (1 << (r + 1)) == (1 << r)]
            if step:
                rounds.append(step)
        return rounds

    def broadcast_pass() -> Rounds:
        return [[(dst, src, b) for src, dst, b in step]
                for step in reversed(reduce_pass())]

    if kind == "reduce":
        return reduce_pass()
    if kind == "broadcast":
        return broadcast_pass()
    if kind == "all_reduce":
        return reduce_pass() + broadcast_pass()
    # tree reduce-scatter / all-gather degenerate to the hd recursion
    return hd_rounds(m, kind, nbytes)


def hd_rounds(members: Sequence[int], kind: str, nbytes: float) -> Rounds:
    """Recursive halving (reduce-scatter) / doubling (all-gather):
    ``log2 p`` pairwise-exchange rounds with geometric payloads. Falls
    back to ring when ``p`` is not a power of two."""
    m = list(members)
    p = len(m)
    if p <= 1 or nbytes <= 0:
        return []
    if p & (p - 1):
        return ring_rounds(m, kind, nbytes)
    depth = p.bit_length() - 1
    rounds: Rounds = []
    if kind == "reduce_scatter":
        for r in range(depth):
            dist = p >> (r + 1)
            size = nbytes / (1 << (r + 1))
            rounds.append([(m[i], m[i ^ dist], size) for i in range(p)])
        return rounds
    if kind == "all_gather":
        for r in range(depth):
            dist = 1 << r
            size = nbytes * (1 << r) / p
            rounds.append([(m[i], m[i ^ dist], size) for i in range(p)])
        return rounds
    if kind == "all_reduce":
        return (hd_rounds(m, "reduce_scatter", nbytes)
                + hd_rounds(m, "all_gather", nbytes))
    raise ValueError(f"hd_rounds does not implement {kind!r}")


def pairwise_rounds(members: Sequence[int], nbytes: float) -> Rounds:
    """Pairwise-exchange all-to-all: round r, member i sends its ``n/p``
    shard to member ``(i + r) mod p``."""
    m = list(members)
    p = len(m)
    if p <= 1 or nbytes <= 0:
        return []
    shard = nbytes / p
    return [[(m[i], m[(i + r) % p], shard) for i in range(p)]
            for r in range(1, p)]


def rounds_for(algorithm: str, kind: str, members: Sequence[int],
               nbytes: float, root: Optional[int] = None) -> Rounds:
    """Schedule ``kind`` over ``members`` with the named algorithm.
    Broadcast/reduce always use the binomial tree; all-to-all always the
    pairwise exchange (the algorithm knob selects among the bulk kinds)."""
    if kind in ("broadcast", "reduce"):
        return tree_rounds(members, kind, nbytes, root=root)
    if kind == "all_to_all":
        return pairwise_rounds(members, nbytes)
    if algorithm == "ring":
        return ring_rounds(members, kind, nbytes)
    if algorithm == "tree":
        return tree_rounds(members, kind, nbytes, root=root)
    if algorithm == "hd":
        return hd_rounds(members, kind, nbytes)
    raise ValueError(f"unknown fabric algorithm {algorithm!r}")


def alpha_beta_lower_bound(kind: str, p: int, nbytes: float,
                           bw: float) -> float:
    """Bandwidth-term lower bound (alpha-beta model, latency dropped):
    no algorithm moves the payload in less link time than this."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    if kind == "all_reduce":
        return 2 * (p - 1) / p * nbytes / bw
    if kind in ("reduce_scatter", "all_gather", "all_to_all"):
        return (p - 1) / p * nbytes / bw
    if kind in ("broadcast", "reduce"):
        return nbytes / bw
    raise ValueError(kind)
