"""DRAM model — PALM §IV-C ❸ (Eq. 4/5).

DRAM bandwidth is a resource occupied during execution, exactly like NoC
links. In tiled accelerators DRAM sits at the array edge (or off-wafer):
an access must traverse the NoC to the nearest DRAM port, so

    DRAM_Time = Access_Time + NoC_Time            (Eq. 5)
    Access_Time = Response_Time + Size / BW_DRAM  (Eq. 4)

Devices with local HBM (GPUs/TPUs: ``hardware.dram_ports == ()``) skip the
NoC leg and contend only on their private channel.
"""

from __future__ import annotations

from typing import Dict, Generator, Optional

from .events import Environment, Resource
from .hardware import HardwareSpec
from .noc import NoCModel
from .trace import KIND_DRAM, TraceRecorder, pack_lane

__all__ = ["DRAMModel"]


class DRAMModel:
    def __init__(self, env: Environment, hardware: HardwareSpec, noc: NoCModel,
                 recorder: Optional[TraceRecorder] = None,
                 resource_base: int = 0):
        self.env = env
        self.hw = hardware
        self.noc = noc
        # when set, every channel records its busy intervals into the
        # trace's DRAM resource lane. ``resource_base`` offsets the
        # recorded/reported channel keys so per-chip DRAM instances of a
        # multi-chip fabric occupy disjoint trace-lane id ranges.
        self.recorder = recorder
        self.resource_base = resource_base
        self._channels: Dict[int, Resource] = {}
        self.bytes_accessed = 0.0

    def _channel(self, key: int) -> Resource:
        res = self._channels.get(key)
        if res is None:
            cb = (self.recorder.interval_cb(KIND_DRAM,
                                            self.resource_base + key)
                  if self.recorder is not None else None)
            res = Resource(self.env, capacity=1, name=f"dram{key}",
                           interval_cb=cb)
            self._channels[key] = res
        return res

    def occupancy_report(self) -> Dict[int, float]:
        """Channel utilizations in sorted key order."""
        return {self.resource_base + key: self._channels[key].utilization()
                for key in sorted(self._channels)}

    def close_open_intervals(self, t: float) -> None:
        """Flush still-busy channels into the recorder at simulation end."""
        if self.recorder is None:
            return
        for key in sorted(self._channels):
            since = self._channels[key].busy_since
            if since is not None and t > since:
                self.recorder.resource(KIND_DRAM, self.resource_base + key,
                                       since, t)

    def access(self, device: int, nbytes: float, priority: int = 0,
               write: bool = False) -> Generator:
        """Process: one DRAM read/write issued by ``device``."""
        if nbytes <= 0:
            yield self.env.timeout(0.0)
            return
        self.bytes_accessed += nbytes
        spec = self.hw.dram
        port = self.hw.nearest_dram_port(device)

        if port is not None and port != device:
            # NoC leg to the edge port (Eq. 5); same exclusive-link semantics
            src, dst = (device, port) if write else (port, device)
            yield self.env.process(self.noc.transfer(src, dst, nbytes, priority))

        # channel contention: shared edge channels, or per-device HBM
        key = port if port is not None else device % max(1, spec.channels)
        chan = self._channel(key)
        req = chan.request(priority)
        yield req
        yield self.env.timeout(spec.response_time + nbytes / spec.bandwidth)  # Eq. (4)
        chan.release(req)

    # -- fast-path pricing (repro_torch.core.fastpath) -------------------------------
    def access_chain(self, device: int, nbytes: float,
                     write: bool = False) -> list:
        """Uncontended price of :meth:`access` as a fast-path chain."""
        if nbytes <= 0:
            return [("dt", 0.0)]
        spec = self.hw.dram
        port = self.hw.nearest_dram_port(device)
        chain: list = [("bytes", "dram", nbytes)]
        if port is not None and port != device:
            src, dst = (device, port) if write else (port, device)
            chain.extend(self.noc.transfer_chain(src, dst, nbytes))
        key = port if port is not None else device % max(1, spec.channels)
        chain.append(("hold", (pack_lane(KIND_DRAM, self.resource_base + key),),
                      spec.response_time + nbytes / spec.bandwidth))
        return chain

    def group_access_chain(self, devices, nbytes_per_device: float,
                           write: bool = False, shared_bytes: float = 0.0,
                           num_shards: int = 1) -> list:
        """Uncontended price of :meth:`group_access` as a fast-path chain."""
        if not self.hw.dram_ports:
            rep = next(iter(devices))
            return self.access_chain(rep, nbytes_per_device + shared_bytes,
                                     write)
        n_dev = len(list(devices))
        per_port: Dict[Optional[int], list] = {}
        for d in devices:
            per_port.setdefault(self.hw.nearest_dram_port(d), []).append(d)
        total_shared = shared_bytes * num_shards
        branches = []
        for port, devs in per_port.items():
            rep = devs[0]
            total = (nbytes_per_device * len(devs)
                     + total_shared * len(devs) / n_dev)
            branches.append(self.access_chain(rep, total, write))
        if not branches:
            return [("dt", 0.0)]
        return [("par", tuple(branches))]

    def group_access(self, devices, nbytes_per_device: float, priority: int = 0,
                     write: bool = False, shared_bytes: float = 0.0,
                     num_shards: int = 1) -> Generator:
        """Process: a tile group's concurrent DRAM accesses (virtual-tile
        aggregation).

        ``nbytes_per_device`` is per-tile-distinct traffic (activations);
        ``shared_bytes`` (x ``num_shards``) is weight traffic whose shards
        are identical across DP replicas — fetched once per shard and
        multicast on the NoC (dataflow weight streaming).

        Edge-shared DRAM (tiled accelerators): one representative request
        per distinct port carrying that port's group-aggregate bytes —
        ports are the shared, contended resource (§IV-C ❸).

        Local HBM (GPUs/TPUs, ``dram_ports == ()``): every device owns a
        private channel; each device fetches its own copy concurrently, so
        the representative request carries per-device bytes.
        """
        if not self.hw.dram_ports:
            rep = next(iter(devices))
            yield self.env.process(self.access(rep, nbytes_per_device + shared_bytes,
                                               priority, write))
            return
        n_dev = len(list(devices))
        per_port: Dict[Optional[int], list] = {}
        for d in devices:
            per_port.setdefault(self.hw.nearest_dram_port(d), []).append(d)
        total_shared = shared_bytes * num_shards
        procs = []
        for port, devs in per_port.items():
            rep = devs[0]
            total = nbytes_per_device * len(devs) + total_shared * len(devs) / n_dev
            procs.append(self.env.process(self.access(rep, total, priority, write)))
        if procs:
            yield self.env.all_of(procs)
        else:
            yield self.env.timeout(0.0)
