"""Event-driven scale-out fabric model (the multi-chip interconnect).

:class:`FabricModel` is a drop-in replacement for the scheduler's
:class:`~repro_torch.core.noc.NoCModel`: it owns one NoC instance *per chip*
(device ids are global — ``chip * chip_size + local``) plus the fabric's
switched up/down links as first-class exclusive
:class:`~repro_torch.core.events.Resource` objects, so cross-chip collectives
compile into sequences of link-holding transfer events that contend with
each other and appear as FABRIC lanes in the trace. :class:`ClusterDRAM`
is the matching drop-in for :class:`~repro_torch.core.dram.DRAMModel` (one DRAM
instance per chip).

A collective whose group sits on one chip delegates to that chip's NoC
untouched; a chip-spanning group decomposes into

1. an intra-chip NoC leg (reduce onto each chip's gateway leader),
2. per-level fabric legs among the chip leaders — the algorithm schedules
   from :mod:`repro_torch.fabric.collectives`, priced over the fabric route and
   executed per the fidelity mode, and
3. an intra-chip broadcast leg from each leader.

Fidelity mirrors :class:`~repro_torch.core.enums.NoCMode`:

* ``detailed``   — every schedule round is a barrier of concurrent
  link-holding chip-to-chip transfers;
* ``macro``      — one closed-form hold of the schedule's whole link
  footprint (contention between collectives preserved, O(1) events);
* ``analytical`` — pure closed form, no resources.
"""

from __future__ import annotations

from typing import Dict, Generator, List, Optional, Sequence, Tuple

from ..core.dram import DRAMModel
from ..core.enums import NoCMode
from ..core.events import Environment, Resource
from ..core.hardware import HardwareSpec
from ..core.noc import NoCModel
from ..core.trace import KIND_FABRIC, TraceRecorder, pack_lane
from .collectives import Rounds, rounds_for
from .spec import FabricSpec

__all__ = ["FabricModel", "ClusterDRAM"]

# local device that fronts each chip's fabric port (data enters/leaves
# the chip NoC here)
GATEWAY = 0


class FabricModel:
    """Cluster interconnect: per-chip NoCs + multi-level fabric links."""

    def __init__(self, env: Environment, hardware: HardwareSpec,
                 mode: NoCMode = NoCMode.MACRO,
                 recorder: Optional[TraceRecorder] = None):
        spec = getattr(hardware, "fabric", None)
        if spec is None:
            raise ValueError(f"hardware {hardware.name!r} has no fabric spec")
        self.env = env
        self.hw = hardware
        self.spec: FabricSpec = spec
        self.mode = NoCMode(mode)
        self.recorder = recorder
        self.chip_size = hardware.topology.num_devices
        self.num_chips = spec.num_chips
        noc_stride = hardware.topology.num_links()
        self.nocs: List[NoCModel] = [
            NoCModel(env, hardware, self.mode, recorder=recorder,
                     resource_base=c * noc_stride)
            for c in range(self.num_chips)]
        self._noc_stride = noc_stride
        self._flinks: Dict[int, Resource] = {}
        self.fabric_bytes = 0.0
        self.fabric_transfers = 0
        # per-hierarchy-level payload accounting (sim-domain metric):
        # populated only when metrics_levels is set by the simulator.
        # Byte counts are integral-valued floats, so sums are exact in
        # any accumulation order — both tiers agree bit-for-bit.
        self.level_bytes: Dict[int, float] = {}
        self.metrics_levels = False
        self.dram = ClusterDRAM(self)

    # -- device arithmetic ---------------------------------------------------
    def chip_of(self, device: int) -> int:
        return device // self.chip_size

    def local(self, device: int) -> int:
        return device % self.chip_size

    def _gateway(self, chip: int) -> int:
        """Global id of a chip's fabric gateway device."""
        return chip * self.chip_size + GATEWAY

    # -- fabric link resources -----------------------------------------------
    def _flink(self, fid: int) -> Resource:
        res = self._flinks.get(fid)
        if res is None:
            cb = (self.recorder.interval_cb(KIND_FABRIC, fid)
                  if self.recorder is not None else None)
            res = Resource(self.env, capacity=1, name=f"flink{fid}",
                           interval_cb=cb)
            self._flinks[fid] = res
        return res

    def _path_time(self, route: Sequence[int], nbytes: float) -> float:
        """Wormhole-pipelined fabric path cost (Eq. 2 analogue)."""
        if not route:
            return 0.0
        lat = sum(self.spec.link_latency(f) for f in route)
        bw = min(self.spec.link_bandwidth(f) for f in route)
        return lat + nbytes / bw

    def _pair_time(self, src_chip: int, dst_chip: int, nbytes: float) -> float:
        return self._path_time(self.spec.route(src_chip, dst_chip), nbytes)

    def _hold(self, link_ids: Sequence[int], t: float,
              priority: int) -> Generator:
        """Acquire fabric links in sorted-id order (deadlock-free), hold
        for ``t``, release."""
        reqs = []
        for fid in sorted(set(link_ids)):
            link = self._flink(fid)
            req = link.request(priority)
            yield req
            reqs.append((link, req))
        yield self.env.timeout(t)
        for link, req in reqs:
            link.release(req)

    def _accum_levels(self, legs) -> None:
        """Attribute ``(route, nbytes)`` legs to the hierarchy levels
        they cross: every traversed link at level L carries ``nbytes``.
        Pre-aggregates per call before folding into ``level_bytes`` —
        the same float association the fast tier applies when replaying
        the per-node ``_level_item`` metadata, so both tiers produce
        bit-identical level sums."""
        lb = self.level_bytes
        for lvl, b in self._level_item(legs):
            lb[lvl] = lb.get(lvl, 0.0) + b

    def _level_item(self, legs) -> Tuple:
        """Chain-node metadata form of :meth:`_accum_levels` over
        ``(route, nbytes)`` legs: sorted ``(level, bytes)`` pairs."""
        acc: Dict[int, float] = {}
        for route, nbytes in legs:
            for fid in route:
                lvl = self.spec.link_level(fid)
                acc[lvl] = acc.get(lvl, 0.0) + nbytes
        return tuple(sorted(acc.items()))

    def _fabric_leg(self, src_chip: int, dst_chip: int, nbytes: float,
                    priority: int) -> Generator:
        """One chip-to-chip fabric transfer (gateway to gateway)."""
        self.fabric_bytes += nbytes
        self.fabric_transfers += 1
        route = self.spec.route(src_chip, dst_chip)
        if self.metrics_levels and route:
            self._accum_levels([(route, nbytes)])
        t = self._path_time(route, nbytes)
        if self.mode == NoCMode.ANALYTICAL or not route:
            yield self.env.timeout(t)
            return
        yield from self._hold(route, t, priority)

    # -- schedule execution ----------------------------------------------------
    def _rounds_time(self, rounds: Rounds) -> float:
        return sum(max((self._pair_time(s, d, b) for s, d, b in rnd),
                       default=0.0) for rnd in rounds)

    def _rounds_footprint(self, rounds: Rounds) -> List[int]:
        fp = set()
        for rnd in rounds:
            for s, d, _ in rnd:
                fp.update(self.spec.route(s, d))
        return sorted(fp)

    def _exec_rounds(self, rounds: Rounds, priority: int) -> Generator:
        """Run a collective schedule per the fidelity mode."""
        env = self.env
        if not rounds:
            yield env.timeout(0.0)
            return
        if self.mode == NoCMode.DETAILED:
            for rnd in rounds:
                procs = [env.process(self._fabric_leg(s, d, b, priority))
                         for s, d, b in rnd]
                yield env.all_of(procs)
            return
        total_bytes = sum(b for rnd in rounds for _, _, b in rnd)
        self.fabric_bytes += total_bytes
        self.fabric_transfers += 1
        if self.metrics_levels:
            self._accum_levels((self.spec.route(s, d), b)
                               for rnd in rounds for s, d, b in rnd)
        t = self._rounds_time(rounds)
        if self.mode == NoCMode.ANALYTICAL:
            yield env.timeout(t)
            return
        yield from self._hold(self._rounds_footprint(rounds), t, priority)

    # -- hierarchical all-reduce ------------------------------------------------
    def _hier_allreduce_rounds(self, chips: List[int], nbytes: float) -> Rounds:
        """Per-level reduce-scatter up / all-gather down among chip
        leaders; the payload entering level L shrinks by the sibling count
        at every level below (this is what makes hierarchical all-reduce
        cheap on thin upper tiers)."""
        spec = self.spec
        reps = sorted(chips)
        payload: Dict[int, float] = {c: nbytes for c in reps}
        up: Rounds = []
        stack: List[Tuple[int, List[List[int]], Dict[int, float]]] = []
        for lvl in range(spec.num_levels):
            if len(reps) <= 1:
                break
            groups: Dict[int, List[int]] = {}
            for c in reps:
                groups.setdefault(c // spec.chips_per_group(lvl), []).append(c)
            group_list = [sorted(g) for _, g in sorted(groups.items())]
            entering = dict(payload)
            per_group = [
                rounds_for(spec.levels[lvl].algorithm, "reduce_scatter",
                           members, max(payload[m] for m in members))
                for members in group_list if len(members) > 1]
            up.extend(_merge_rounds(per_group))
            stack.append((lvl, group_list, entering))
            reps = []
            for members in group_list:
                rep = members[0]
                if len(members) > 1:
                    payload[rep] = max(payload[m] for m in members) / len(members)
                reps.append(rep)
        down: Rounds = []
        for lvl, group_list, entering in reversed(stack):
            per_group = [
                rounds_for(spec.levels[lvl].algorithm, "all_gather",
                           members, max(entering[m] for m in members))
                for members in group_list if len(members) > 1]
            down.extend(_merge_rounds(per_group))
        return up + down

    def _cross_rounds(self, kind: str, chips: List[int], nbytes: float,
                      root_chip: Optional[int] = None) -> Rounds:
        """Cross-chip schedule among the chip leaders."""
        family = self.spec.collective
        if kind == "all_reduce" and family == "hierarchical":
            return self._hier_allreduce_rounds(chips, nbytes)
        if kind in ("reduce_scatter", "all_gather") and family == "hierarchical":
            # per-level recursion for RS/AG alone approximates to the
            # halving-doubling schedule over the flat chip set
            return rounds_for("hd", kind, sorted(chips), nbytes)
        return rounds_for(family if family != "hierarchical" else "ring",
                          kind, sorted(chips), nbytes, root=root_chip)

    # -- NoCModel-compatible surface --------------------------------------------
    @property
    def bytes_moved(self) -> float:
        return self.fabric_bytes + sum(n.bytes_moved for n in self.nocs)

    @property
    def transfer_count(self) -> int:
        return self.fabric_transfers + sum(n.transfer_count for n in self.nocs)

    @property
    def _links(self) -> Dict[int, Resource]:
        """Merged resource view (truthy iff any link was touched)."""
        merged: Dict[int, Resource] = {}
        for c, noc in enumerate(self.nocs):
            for lid, res in noc._links.items():
                merged[c * self._noc_stride + lid] = res
        base = self.num_chips * self._noc_stride
        for fid, res in self._flinks.items():
            merged[base + fid] = res
        return merged

    def occupancy_report(self) -> Dict[int, float]:
        """Chip NoC link utilizations (chip-offset ids) followed by fabric
        link utilizations (offset past every chip's id range)."""
        out: Dict[int, float] = {}
        for noc in self.nocs:
            out.update(noc.occupancy_report())
        base = self.num_chips * self._noc_stride
        for fid in sorted(self._flinks):
            out[base + fid] = self._flinks[fid].utilization()
        return out

    def close_open_intervals(self, t: float) -> None:
        for noc in self.nocs:
            noc.close_open_intervals(t)
        if self.recorder is None:
            return
        for fid in sorted(self._flinks):
            since = self._flinks[fid].busy_since
            if since is not None and t > since:
                self.recorder.resource(KIND_FABRIC, fid, since, t)

    def transfer(self, src: int, dst: int, nbytes: float,
                 priority: int = 0) -> Generator:
        """Process: move ``nbytes`` between two global devices. Same-chip
        transfers delegate to the chip NoC; cross-chip transfers take a
        NoC leg to the source gateway, the fabric route, and a NoC leg
        from the destination gateway."""
        env = self.env
        cs, cd = self.chip_of(src), self.chip_of(dst)
        if cs == cd:
            yield env.process(self.nocs[cs].transfer(
                self.local(src), self.local(dst), nbytes, priority))
            return
        if self.local(src) != GATEWAY:
            yield env.process(self.nocs[cs].transfer(
                self.local(src), GATEWAY, nbytes, priority))
        yield from self._fabric_leg(cs, cd, nbytes, priority)
        if self.local(dst) != GATEWAY:
            yield env.process(self.nocs[cd].transfer(
                GATEWAY, self.local(dst), nbytes, priority))

    def collective(self, kind: str, group: Sequence[int], nbytes: float,
                   priority: int = 0, root: Optional[int] = None) -> Generator:
        """Process: run a collective over global device ids. Groups on a
        single chip go straight to that chip's NoC; chip-spanning groups
        decompose into intra-chip legs + per-level fabric legs."""
        env = self.env
        if len(group) <= 1 or nbytes <= 0:
            yield env.timeout(0.0)
            return
        by_chip: Dict[int, List[int]] = {}
        for d in group:
            by_chip.setdefault(self.chip_of(d), []).append(self.local(d))
        if len(by_chip) == 1:
            chip, locs = next(iter(by_chip.items()))
            local_root = (self.local(root)
                          if root is not None and self.chip_of(root) == chip
                          else None)
            yield env.process(self.nocs[chip].collective(
                kind, locs, nbytes, priority, root=local_root))
            return
        yield from self._cross_chip(kind, by_chip, nbytes, priority, root)

    def _intra(self, by_chip: Dict[int, List[int]], kind: str, nbytes: float,
               priority: int, roots: Optional[Dict[int, int]] = None) -> Generator:
        """Concurrent per-chip NoC collectives (chips with one member
        skip theirs)."""
        env = self.env
        procs = []
        for chip in sorted(by_chip):
            locs = by_chip[chip]
            if len(locs) > 1:
                root = roots.get(chip) if roots is not None else None
                procs.append(env.process(self.nocs[chip].collective(
                    kind, locs, nbytes, priority, root=root)))
        if procs:
            yield env.all_of(procs)
        else:
            yield env.timeout(0.0)

    def _cross_chip(self, kind: str, by_chip: Dict[int, List[int]],
                    nbytes: float, priority: int,
                    root: Optional[int]) -> Generator:
        env = self.env
        chips = sorted(by_chip)
        leaders = {chip: min(locs) for chip, locs in by_chip.items()}
        root_chip = self.chip_of(root) if root is not None else chips[0]

        if kind == "all_reduce":
            yield from self._intra(by_chip, "reduce", nbytes, priority,
                                   roots=leaders)
            yield from self._exec_rounds(
                self._cross_rounds("all_reduce", chips, nbytes), priority)
            yield from self._intra(by_chip, "broadcast", nbytes, priority,
                                   roots=leaders)
        elif kind in ("reduce_scatter", "all_gather"):
            if kind == "reduce_scatter":
                yield from self._intra(by_chip, kind, nbytes, priority)
                yield from self._exec_rounds(
                    self._cross_rounds(kind, chips, nbytes), priority)
            else:
                yield from self._exec_rounds(
                    self._cross_rounds(kind, chips, nbytes), priority)
                yield from self._intra(by_chip, kind, nbytes, priority)
        elif kind == "all_to_all":
            yield from self._intra(by_chip, kind, nbytes, priority)
            yield from self._exec_rounds(
                self._cross_rounds(kind, chips, nbytes), priority)
        elif kind == "broadcast":
            yield from self._exec_rounds(
                rounds_for("tree", "broadcast", chips, nbytes,
                           root=root_chip), priority)
            yield from self._intra(by_chip, "broadcast", nbytes, priority,
                                   roots=leaders)
        elif kind == "reduce":
            yield from self._intra(by_chip, "reduce", nbytes, priority,
                                   roots=leaders)
            yield from self._exec_rounds(
                rounds_for("tree", "reduce", chips, nbytes,
                           root=root_chip), priority)
        else:
            raise ValueError(f"unknown collective kind {kind!r}")

    # -- fast-path pricing (repro_torch.core.fastpath) -------------------------------
    def _fabric_leg_chain(self, src_chip: int, dst_chip: int,
                          nbytes: float) -> List:
        """Uncontended price of :meth:`_fabric_leg` as a fast-path chain."""
        route = self.spec.route(src_chip, dst_chip)
        t = self._path_time(route, nbytes)
        bnode = ("bytes", "fabric", nbytes)
        if self.metrics_levels and route:
            bnode = bnode + (self._level_item([(route, nbytes)]),)
        if self.mode == NoCMode.ANALYTICAL or not route:
            return [bnode, ("dt", t)]
        return [bnode,
                ("hold", tuple(pack_lane(KIND_FABRIC, fid)
                               for fid in sorted(set(route))), t)]

    def transfer_chain(self, src: int, dst: int, nbytes: float) -> List:
        """Uncontended price of :meth:`transfer` as a fast-path chain."""
        cs, cd = self.chip_of(src), self.chip_of(dst)
        if cs == cd:
            return self.nocs[cs].transfer_chain(self.local(src),
                                                self.local(dst), nbytes)
        chain: List = []
        if self.local(src) != GATEWAY:
            chain.extend(self.nocs[cs].transfer_chain(self.local(src),
                                                      GATEWAY, nbytes))
        chain.extend(self._fabric_leg_chain(cs, cd, nbytes))
        if self.local(dst) != GATEWAY:
            chain.extend(self.nocs[cd].transfer_chain(GATEWAY,
                                                      self.local(dst), nbytes))
        return chain

    def _exec_rounds_chain(self, rounds: Rounds) -> List:
        """Uncontended price of :meth:`_exec_rounds` as a fast-path chain."""
        if not rounds:
            return [("dt", 0.0)]
        if self.mode == NoCMode.DETAILED:
            return [("par", tuple(self._fabric_leg_chain(s, d, b)
                                  for s, d, b in rnd))
                    for rnd in rounds]
        total_bytes = sum(b for rnd in rounds for _, _, b in rnd)
        t = self._rounds_time(rounds)
        bnode = ("bytes", "fabric", total_bytes)
        if self.metrics_levels:
            bnode = bnode + (self._level_item(
                (self.spec.route(s, d), b)
                for rnd in rounds for s, d, b in rnd),)
        if self.mode == NoCMode.ANALYTICAL:
            return [bnode, ("dt", t)]
        return [bnode,
                ("hold", tuple(pack_lane(KIND_FABRIC, fid)
                               for fid in self._rounds_footprint(rounds)), t)]

    def _intra_chain(self, by_chip: Dict[int, List[int]], kind: str,
                     nbytes: float,
                     roots: Optional[Dict[int, int]] = None) -> List:
        """Uncontended price of :meth:`_intra` as a fast-path chain."""
        branches = []
        for chip in sorted(by_chip):
            locs = by_chip[chip]
            if len(locs) > 1:
                root = roots.get(chip) if roots is not None else None
                branches.append(self.nocs[chip].collective_chain(
                    kind, locs, nbytes, root=root))
        return [("par", tuple(branches))] if branches else [("dt", 0.0)]

    def collective_chain(self, kind: str, group: Sequence[int], nbytes: float,
                         root: Optional[int] = None) -> List:
        """Uncontended price of :meth:`collective` as a fast-path chain."""
        if len(group) <= 1 or nbytes <= 0:
            return [("dt", 0.0)]
        by_chip: Dict[int, List[int]] = {}
        for d in group:
            by_chip.setdefault(self.chip_of(d), []).append(self.local(d))
        if len(by_chip) == 1:
            chip, locs = next(iter(by_chip.items()))
            local_root = (self.local(root)
                          if root is not None and self.chip_of(root) == chip
                          else None)
            return self.nocs[chip].collective_chain(kind, locs, nbytes,
                                                    root=local_root)
        chips = sorted(by_chip)
        leaders = {chip: min(locs) for chip, locs in by_chip.items()}
        root_chip = self.chip_of(root) if root is not None else chips[0]
        chain: List = []
        if kind == "all_reduce":
            chain += self._intra_chain(by_chip, "reduce", nbytes,
                                       roots=leaders)
            chain += self._exec_rounds_chain(
                self._cross_rounds("all_reduce", chips, nbytes))
            chain += self._intra_chain(by_chip, "broadcast", nbytes,
                                       roots=leaders)
        elif kind in ("reduce_scatter", "all_gather"):
            if kind == "reduce_scatter":
                chain += self._intra_chain(by_chip, kind, nbytes)
                chain += self._exec_rounds_chain(
                    self._cross_rounds(kind, chips, nbytes))
            else:
                chain += self._exec_rounds_chain(
                    self._cross_rounds(kind, chips, nbytes))
                chain += self._intra_chain(by_chip, kind, nbytes)
        elif kind == "all_to_all":
            chain += self._intra_chain(by_chip, kind, nbytes)
            chain += self._exec_rounds_chain(
                self._cross_rounds(kind, chips, nbytes))
        elif kind == "broadcast":
            chain += self._exec_rounds_chain(
                rounds_for("tree", "broadcast", chips, nbytes,
                           root=root_chip))
            chain += self._intra_chain(by_chip, "broadcast", nbytes,
                                       roots=leaders)
        elif kind == "reduce":
            chain += self._intra_chain(by_chip, "reduce", nbytes,
                                       roots=leaders)
            chain += self._exec_rounds_chain(
                rounds_for("tree", "reduce", chips, nbytes, root=root_chip))
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        return chain

    def group_to_group(self, src_group: Sequence[int],
                       dst_group: Sequence[int], nbytes: float,
                       strategy: int = 1, num_adapters: int = 1,
                       priority: int = 0) -> Generator:
        """Inter-stage tensor hand-off across global device groups. When
        both groups sit on one chip the chip NoC's §V-C strategies apply
        verbatim; otherwise: reduce in the source group, one fabric
        transfer leader-to-leader, broadcast in the destination group."""
        env = self.env
        src, dst = list(src_group), list(dst_group)
        src_chips = {self.chip_of(d) for d in src}
        dst_chips = {self.chip_of(d) for d in dst}
        if len(src_chips | dst_chips) == 1:
            chip = next(iter(src_chips))
            yield env.process(self.nocs[chip].group_to_group(
                [self.local(d) for d in src], [self.local(d) for d in dst],
                nbytes, strategy=strategy, num_adapters=num_adapters,
                priority=priority))
            return
        src_leader, dst_leader = min(src), min(dst)
        if len(src) > 1:
            yield env.process(self.collective("reduce", src, nbytes, priority,
                                              root=src_leader))
        yield env.process(self.transfer(src_leader, dst_leader, nbytes,
                                        priority))
        if len(dst) > 1:
            yield env.process(self.collective("broadcast", dst, nbytes,
                                              priority, root=dst_leader))


def _merge_rounds(per_group: List[Rounds]) -> Rounds:
    """Zip concurrent per-group schedules round-by-round (sibling groups
    at one level run in parallel)."""
    if not per_group:
        return []
    depth = max(len(r) for r in per_group)
    return [[msg for rounds in per_group if i < len(rounds)
             for msg in rounds[i]]
            for i in range(depth)]


class ClusterDRAM:
    """DRAMModel-compatible facade: one DRAM instance per chip, device
    ids global. Weight-stream traffic (``shared_bytes``) is split across
    chips in proportion to each chip's share of the group."""

    def __init__(self, fabric: FabricModel):
        self.fabric = fabric
        self.env = fabric.env
        hw = fabric.hw
        stride = max(fabric.chip_size, hw.dram.channels)
        self.drams: List[DRAMModel] = [
            DRAMModel(fabric.env, hw, fabric.nocs[c],
                      recorder=fabric.recorder, resource_base=c * stride)
            for c in range(fabric.num_chips)]

    @property
    def bytes_accessed(self) -> float:
        return sum(d.bytes_accessed for d in self.drams)

    def occupancy_report(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for d in self.drams:
            out.update(d.occupancy_report())
        return out

    def close_open_intervals(self, t: float) -> None:
        for d in self.drams:
            d.close_open_intervals(t)

    def access(self, device: int, nbytes: float, priority: int = 0,
               write: bool = False) -> Generator:
        chip = self.fabric.chip_of(device)
        yield self.env.process(self.drams[chip].access(
            self.fabric.local(device), nbytes, priority, write))

    # -- fast-path pricing (repro_torch.core.fastpath) -------------------------------
    def access_chain(self, device: int, nbytes: float,
                     write: bool = False) -> List:
        chip = self.fabric.chip_of(device)
        return self.drams[chip].access_chain(self.fabric.local(device),
                                             nbytes, write)

    def group_access_chain(self, devices, nbytes_per_device: float,
                           write: bool = False, shared_bytes: float = 0.0,
                           num_shards: int = 1) -> List:
        devs = list(devices)
        by_chip: Dict[int, List[int]] = {}
        for d in devs:
            by_chip.setdefault(self.fabric.chip_of(d), []).append(
                self.fabric.local(d))
        n_total = max(1, len(devs))
        branches = [self.drams[chip].group_access_chain(
                        by_chip[chip], nbytes_per_device, write,
                        shared_bytes * len(by_chip[chip]) / n_total,
                        num_shards)
                    for chip in sorted(by_chip)]
        return [("par", tuple(branches))] if branches else [("dt", 0.0)]

    def group_access(self, devices, nbytes_per_device: float,
                     priority: int = 0, write: bool = False,
                     shared_bytes: float = 0.0,
                     num_shards: int = 1) -> Generator:
        devs = list(devices)
        by_chip: Dict[int, List[int]] = {}
        for d in devs:
            by_chip.setdefault(self.fabric.chip_of(d), []).append(
                self.fabric.local(d))
        n_total = max(1, len(devs))
        procs = []
        for chip in sorted(by_chip):
            locs = by_chip[chip]
            procs.append(self.env.process(self.drams[chip].group_access(
                locs, nbytes_per_device, priority, write,
                shared_bytes * len(locs) / n_total, num_shards)))
        if procs:
            yield self.env.all_of(procs)
        else:
            yield self.env.timeout(0.0)
