"""Detailed NoC model — PALM §IV-C ❷ (Eq. 2/3) and collectives (§II-B).

The paper's key modeling decision: *links are exclusive resources during
execution*. A transfer that needs occupied links waits (contention delay);
when granted, a wormhole-pipelined transfer takes Eq. (2):

    Comm_Time = Link_Time x Hops + Comm_Size / BW_link(+ contention wait)

Three fidelity levels expose the paper's complexity story (§IV-A):

* ``detailed``   — every ring/all-to-all step is a set of link-holding
  transfer events: O(P^2) events per collective; used for the small
  validation benches (Fig. 6/7/12).
* ``macro``      — a collective holds its whole link footprint once for its
  closed-form duration; contention *between* collectives and DRAM traffic
  is preserved with O(1) events per collective. This is the
  "analytical model for the NoC" that takes Virtual Tile Aggregation to
  O(M) (§IV-A).
* ``analytical`` — pure closed form, no resources at all (the baseline the
  paper compares against in Fig. 7).

Collective cost closed forms (ring algorithms, P participants, S bytes
per participant): all-reduce 2(P-1)/P * S per link; reduce-scatter and
all-gather (P-1)/P * S; all-to-all (P-1)/P * S bisection-limited.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Generator, Iterable, List, Optional, Sequence, Tuple

from .enums import NoCMode
from .events import Environment, Resource
from .hardware import HardwareSpec, Topology
from .trace import KIND_NOC, TraceRecorder, pack_lane

__all__ = ["NoCModel", "collective_steps", "ring_time"]


def collective_steps(kind: str, p: int) -> int:
    if p <= 1:
        return 0
    return {"all_reduce": 2 * (p - 1), "reduce_scatter": p - 1, "all_gather": p - 1,
            "all_to_all": p - 1, "broadcast": 1, "reduce": 1}[kind]


def _chunk_bytes(kind: str, nbytes: float, p: int) -> float:
    """Bytes moved per participant per step for ring algorithms."""
    if p <= 1:
        return 0.0
    if kind in ("all_reduce", "reduce_scatter", "all_gather"):
        return nbytes / p
    if kind == "all_to_all":
        return nbytes / p          # one distinct shard per peer per step
    if kind in ("broadcast", "reduce"):
        return nbytes
    raise ValueError(kind)


def ring_time(kind: str, nbytes: float, p: int, bw: float, hop_latency: float,
              hops_per_step: int = 1) -> float:
    """Closed-form ring collective time (used by macro/analytical modes)."""
    steps = collective_steps(kind, p)
    if steps == 0:
        return 0.0
    per_step = hop_latency * hops_per_step + _chunk_bytes(kind, nbytes, p) / bw
    return steps * per_step


class NoCModel:
    """Event-driven NoC with pluggable fidelity."""

    def __init__(self, env: Environment, hardware: HardwareSpec,
                 mode: NoCMode = NoCMode.DETAILED,
                 recorder: Optional[TraceRecorder] = None,
                 resource_base: int = 0):
        self.env = env
        self.hw = hardware
        self.topo: Topology = hardware.topology
        self.mode = NoCMode(mode)
        # when set, every link records its busy intervals into the trace's
        # NOC resource lane (closed on busy->idle transitions).
        # ``resource_base`` offsets the recorded/reported link ids so the
        # per-chip NoC instances of a multi-chip fabric occupy disjoint
        # trace-lane id ranges (0 for the single-chip simulator).
        self.recorder = recorder
        self.resource_base = resource_base
        self._links: Dict[int, Resource] = {}
        # ring-collective link footprints, keyed by the group tuple (macro
        # mode re-runs the same groups every micro-batch)
        self._footprint_cache: Dict[Tuple[int, ...], List[int]] = {}
        # instrumentation
        self.bytes_moved = 0.0
        self.transfer_count = 0

    # -- resources ------------------------------------------------------------
    def link(self, link_id: int) -> Resource:
        res = self._links.get(link_id)
        if res is None:
            cb = (self.recorder.interval_cb(KIND_NOC,
                                            self.resource_base + link_id)
                  if self.recorder is not None else None)
            res = Resource(self.env, capacity=1, name=f"link{link_id}",
                           interval_cb=cb)
            self._links[link_id] = res
        return res

    def occupancy_report(self) -> Dict[int, float]:
        """Link utilizations in sorted link-id order (deterministic JSON /
        equality across pool workers regardless of link touch order)."""
        return {self.resource_base + lid: self._links[lid].utilization()
                for lid in sorted(self._links)}

    def close_open_intervals(self, t: float) -> None:
        """Flush still-busy links into the recorder at simulation end."""
        if self.recorder is None:
            return
        for lid in sorted(self._links):
            since = self._links[lid].busy_since
            if since is not None and t > since:
                self.recorder.resource(KIND_NOC, self.resource_base + lid,
                                       since, t)

    # -- primitive transfer ------------------------------------------------------
    def _path_time(self, route: Sequence[int], nbytes: float) -> float:
        if not route:
            return 0.0
        lat = sum(self.topo.link_latency(l) for l in route)
        bw = min(self.topo.link_bandwidth(l) for l in route)
        return lat + nbytes / bw  # Eq. (2), wormhole-pipelined

    def transfer(self, src: int, dst: int, nbytes: float, priority: int = 0) -> Generator:
        """Process: move ``nbytes`` from src to dst (holds the whole path —
        'treating the link as an exclusive resource during execution')."""
        self.bytes_moved += nbytes
        self.transfer_count += 1
        # Eq. (2) via the topology's cached path metrics (O(1) per pair)
        hops, lat, bw = self.topo.path_metrics(src, dst)
        t = lat + nbytes / bw if hops else 0.0
        if self.mode == NoCMode.ANALYTICAL or not hops:
            yield self.env.timeout(t)
            return
        # deadlock-free acquisition: global link-id order (cached per pair)
        reqs = []
        for lid in self.topo.route_links(src, dst):
            link = self.link(lid)
            req = link.request(priority)
            yield req
            reqs.append((link, req))
        yield self.env.timeout(t)
        for link, req in reqs:
            link.release(req)

    # -- collectives ------------------------------------------------------------
    def collective(self, kind: str, group: Sequence[int], nbytes: float,
                   priority: int = 0, root: Optional[int] = None) -> Generator:
        """Process: run a collective over ``group`` (device ids, ring order =
        list order). ``nbytes`` is the per-participant payload."""
        p = len(group)
        if p <= 1 or nbytes <= 0:
            yield self.env.timeout(0.0)
            return
        if self.mode == NoCMode.DETAILED:
            yield from self._collective_detailed(kind, list(group), nbytes, priority, root)
        elif self.mode == NoCMode.MACRO:
            yield from self._collective_macro(kind, list(group), nbytes, priority, root)
        else:
            yield self.env.timeout(self._collective_closed_form(kind, list(group), nbytes, root))

    # closed form on the actual topology ---------------------------------------
    def _ring_links(self, group: List[int]) -> List[int]:
        links: List[int] = []
        for i, src in enumerate(group):
            dst = group[(i + 1) % len(group)]
            links.extend(self.topo.route(src, dst))
        return links

    def _ring_footprint(self, group: List[int]) -> List[int]:
        """Sorted de-duplicated ring link set (cached per group)."""
        if not getattr(self.topo, "cache_routing", False):
            return sorted(set(self._ring_links(group)))
        key = tuple(group)
        fp = self._footprint_cache.get(key)
        if fp is None:
            fp = sorted(set(self._ring_links(group)))
            self._footprint_cache[key] = fp
        return fp

    def _chain_links(self, group: List[int], root: Optional[int]) -> List[int]:
        """Chain path visiting the group in order, starting at root."""
        order = list(group)
        if root is not None and root in order:
            order.remove(root)
            order = [root] + order
        links: List[int] = []
        for a, b in zip(order, order[1:]):
            links.extend(self.topo.route(a, b))
        return links

    def _collective_closed_form(self, kind: str, group: List[int], nbytes: float,
                                root: Optional[int]) -> float:
        p = len(group)
        if kind == "broadcast":
            # chain-pipelined (wormhole): the payload streams through the
            # member chain once; time = hop latencies + size / bottleneck bw
            links = self._chain_links(group, root)
            return self._path_time(links, nbytes)
        if kind == "reduce":
            # converging transfers: p-1 full-size payloads funnel into the
            # root's <=4 incident links (what the §V-C strategy-2 cost turns on)
            root = group[0] if root is None else root
            metrics = [self.topo.path_metrics(d, root)
                       for d in group if d != root]
            if not metrics:
                return 0.0
            bw = min((m[2] for m in metrics if m[0]), default=float("inf"))
            fan_in = min(4, len(metrics))
            lat = max(m[1] for m in metrics)
            return lat + len(metrics) * nbytes / (fan_in * bw)
        # ring: pipelined chunks — every chunk crosses every inter-neighbour
        # path, so the slowest path bounds the per-step rate (this is what
        # breaks when the ring has an off-ring member: §V-C)
        chunk = _chunk_bytes(kind, nbytes, p)
        step_times = []
        for i, src in enumerate(group):
            hops, lat, bw = self.topo.path_metrics(src, group[(i + 1) % p])
            step_times.append(lat + chunk / bw if hops else 0.0)
        return collective_steps(kind, p) * max(step_times)

    # macro: closed form + exclusive hold of the link footprint ----------------
    def _collective_macro(self, kind: str, group: List[int], nbytes: float,
                          priority: int, root: Optional[int]) -> Generator:
        self.bytes_moved += nbytes * len(group)
        self.transfer_count += 1
        t = self._collective_closed_form(kind, group, nbytes, root)
        footprint = self._ring_footprint(group)
        reqs = []
        for lid in footprint:
            link = self.link(lid)
            req = link.request(priority)
            yield req
            reqs.append((link, req))
        yield self.env.timeout(t)
        for link, req in reqs:
            link.release(req)

    # detailed: per-step transfers ---------------------------------------------
    def _collective_detailed(self, kind: str, group: List[int], nbytes: float,
                             priority: int, root: Optional[int]) -> Generator:
        env = self.env
        p = len(group)
        if kind == "broadcast":
            # chain-pipelined stream holding the chain's link set once
            self.bytes_moved += nbytes * (p - 1)
            self.transfer_count += 1
            links = self._chain_links(group, root)
            t = self._path_time(links, nbytes)
            reqs = []
            for lid in sorted(set(links)):
                link = self.link(lid)
                req = link.request(priority)
                yield req
                reqs.append((link, req))
            yield env.timeout(t)
            for link, req in reqs:
                link.release(req)
            return
        if kind == "reduce":
            # converging full-size transfers (contend on root's links)
            root = group[0] if root is None else root
            procs = [env.process(self.transfer(d, root, nbytes, priority))
                     for d in group if d != root]
            if procs:
                yield env.all_of(procs)
            return
        steps = collective_steps(kind, p)
        chunk = _chunk_bytes(kind, nbytes, p)
        for _ in range(steps):
            procs = [env.process(self.transfer(group[i], group[(i + 1) % p], chunk, priority))
                     for i in range(p)]
            yield env.all_of(procs)

    # -- fast-path pricing (repro_torch.core.fastpath) -------------------------------
    # Chains are the analytic mirror of the generator bodies above: a flat
    # list of ("dt", x) advances, ("hold", keys, x) resource holds,
    # ("par", branches) concurrent sections and ("bytes", acc, n) counter
    # bumps, composed exactly as the event kernel would accumulate time
    # (sequential yields = additive chain, all_of = max), so evaluating a
    # chain at start time t reproduces the uncontended event timing
    # bit-for-bit. See repro_torch/core/fastpath.py for the evaluator.

    def _link_keys(self, link_ids: Iterable[int]) -> Tuple:
        return tuple(pack_lane(KIND_NOC, self.resource_base + lid)
                     for lid in link_ids)

    def transfer_chain(self, src: int, dst: int, nbytes: float) -> List:
        """Uncontended price of :meth:`transfer` as a fast-path chain."""
        hops, lat, bw = self.topo.path_metrics(src, dst)
        t = lat + nbytes / bw if hops else 0.0
        if self.mode == NoCMode.ANALYTICAL or not hops:
            return [("bytes", "noc", nbytes), ("dt", t)]
        return [("bytes", "noc", nbytes),
                ("hold", self._link_keys(self.topo.route_links(src, dst)), t)]

    def collective_chain(self, kind: str, group: Sequence[int], nbytes: float,
                         root: Optional[int] = None) -> List:
        """Uncontended price of :meth:`collective` as a fast-path chain."""
        p = len(group)
        if p <= 1 or nbytes <= 0:
            return [("dt", 0.0)]
        group = list(group)
        if self.mode == NoCMode.ANALYTICAL:
            return [("dt", self._collective_closed_form(kind, group, nbytes,
                                                        root))]
        if self.mode == NoCMode.MACRO:
            t = self._collective_closed_form(kind, group, nbytes, root)
            return [("bytes", "noc", nbytes * p),
                    ("hold", self._link_keys(self._ring_footprint(group)), t)]
        # detailed: per-step transfer barriers, mirroring _collective_detailed
        if kind == "broadcast":
            links = self._chain_links(group, root)
            t = self._path_time(links, nbytes)
            return [("bytes", "noc", nbytes * (p - 1)),
                    ("hold", self._link_keys(sorted(set(links))), t)]
        if kind == "reduce":
            r = group[0] if root is None else root
            branches = tuple(self.transfer_chain(d, r, nbytes)
                             for d in group if d != r)
            return [("par", branches)] if branches else [("dt", 0.0)]
        steps = collective_steps(kind, p)
        chunk = _chunk_bytes(kind, nbytes, p)
        step = ("par", tuple(self.transfer_chain(group[i], group[(i + 1) % p],
                                                 chunk)
                             for i in range(p)))
        return [step] * steps

    # -- inter-tile-group strategies (paper §V-C, Fig. 11) ----------------------

    def group_to_group(
        self,
        src_group: Sequence[int],
        dst_group: Sequence[int],
        nbytes: float,
        strategy: int = 1,
        num_adapters: int = 1,
        priority: int = 0,
    ) -> Generator:
        """Send a reduced tensor from one tile group to another.

        Strategy 1 (Eq. 7): all-reduce in source -> point-to-point to the
        adapters -> broadcast in destination.
        Strategy 2 (Eq. 8): reduce onto the adapters' peers -> p2p ->
        all-reduce among adapters -> broadcast in destination.
        """
        env = self.env
        src, dst = list(src_group), list(dst_group)
        k = max(1, min(num_adapters, len(src), len(dst)))
        senders, adapters = src[:k], dst[:k]

        if strategy == 1:
            yield env.process(self.collective("all_reduce", src, nbytes, priority))
            shard = nbytes / k
            procs = [env.process(self.transfer(s, a, shard, priority))
                     for s, a in zip(senders, adapters)]
            yield env.all_of(procs)
            yield from self._dest_broadcast(adapters, dst, nbytes, priority)
        elif strategy == 2:
            # reduce within k contiguous source subsets onto the k senders
            m = (len(src) + k - 1) // k
            subsets = [src[i * m:(i + 1) * m] for i in range(k) if src[i * m:(i + 1) * m]]
            procs = [env.process(self.collective("reduce", sub, nbytes, priority, root=sub[0]))
                     for sub in subsets if len(sub) > 1]
            if procs:
                yield env.all_of(procs)
            shard = nbytes  # each adapter receives a partial full-size tensor
            procs = [env.process(self.transfer(sub[0], a, shard, priority))
                     for sub, a in zip(subsets, adapters)]
            yield env.all_of(procs)
            if k > 1:
                yield env.process(self.collective("all_reduce", adapters, nbytes, priority))
            yield from self._dest_broadcast(adapters, dst, nbytes, priority)
        else:
            raise ValueError(f"unknown strategy {strategy}")

    def _dest_broadcast(self, adapters: List[int], dst: List[int], nbytes: float,
                        priority: int) -> Generator:
        env = self.env
        rest = [d for d in dst if d not in adapters]
        if not rest:
            yield env.timeout(0.0)
            return
        # each adapter chain-broadcasts to a contiguous share of the rest
        k = len(adapters)
        m = (len(rest) + k - 1) // k
        procs = []
        for i, a in enumerate(adapters):
            share = rest[i * m:(i + 1) * m]
            if share:
                procs.append(env.process(
                    self.collective("broadcast", [a] + share, nbytes, priority, root=a)))
        if procs:
            yield env.all_of(procs)
