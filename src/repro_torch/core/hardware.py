"""Hardware descriptions for PALM (paper §II-C, §III-C, Tables I & VI).

A :class:`HardwareSpec` is pure data: tile compute/SRAM, NoC topology +
bandwidths, and DRAM channel placement. PALM models a *two-level* tiled
accelerator (tiles composed of cores); the declarative topology specs in
:mod:`repro_torch.core.topology` express both levels (``HierarchicalSpec``) and
compile them into one flattened 2-D core grid whose link bandwidth
depends on whether a hop crosses a tile boundary — faithful to Table VI
while keeping routing uniform.

The hardware layer is declarative end to end: every preset below is
built from a :class:`~repro_torch.core.topology.TopologySpec`, and a
``HardwareSpec`` round-trips losslessly through ``to_dict``/``from_dict``
(and ``to_json``/``from_json``), so machines are data users can dump,
tweak, diff, and sweep (the reference's ``repro.api.HardwareSearchSpace``).

Presets reproduce the hardware used in the paper's case studies plus the
TPU v5e pod used for the roofline cross-check; ``HARDWARE_PRESETS`` maps
names to builders (parameterized ``a100x<N>`` / ``tpu_v5e_<R>x<C>`` names
are resolved by the reference's ``repro.api.resolve_hardware``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .topology import (
    GPUCluster,
    GPUClusterSpec,
    HierarchicalSpec,
    Mesh2D,
    MeshSpec,
    Topology,
    TopologySpec,
    Torus2D,
    spec_of,
    topology_spec_from_dict,
)

__all__ = [
    "TileSpec",
    "DRAMSpec",
    "Topology",
    "Mesh2D",
    "Torus2D",
    "GPUCluster",
    "TopologySpec",
    "MeshSpec",
    "GPUClusterSpec",
    "HierarchicalSpec",
    "HardwareSpec",
    "HARDWARE_PRESETS",
    "grayskull",
    "wafer_scale",
    "a100_cluster",
    "tpu_v5e_pod",
    "tiled_cluster",
]

GB = 1e9
MB = 1e6
TFLOPS = 1e12


@dataclass(frozen=True)
class TileSpec:
    """Per-tile (per-core after flattening) compute + SRAM."""

    flops: float                  # peak FLOP/s at the workload precision
    sram_bytes: float             # local SRAM capacity
    compute_efficiency: float = 0.50   # sustained fraction of peak on dense GEMM
    vector_efficiency: float = 0.15    # sustained fraction for memory-bound ops

    def matmul_time(self, flop: float) -> float:
        return flop / (self.flops * self.compute_efficiency)

    def vector_time(self, flop: float) -> float:
        return flop / (self.flops * self.vector_efficiency)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TileSpec":
        return cls(**d)


@dataclass(frozen=True)
class DRAMSpec:
    """Edge-shared DRAM (paper §IV-C ❸)."""

    bandwidth: float              # bytes/s per channel
    response_time: float = 1e-7   # seconds, Eq. (4) Response_Time
    channels: int = 1             # number of shared channels (edges)
    capacity_bytes: float = float("inf")  # per-device DRAM capacity (recompute trigger)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # JSON has no Infinity: unbounded capacity serializes as null
        if math.isinf(d["capacity_bytes"]):
            d["capacity_bytes"] = None
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DRAMSpec":
        kw = dict(d)
        if kw.get("capacity_bytes") is None:
            kw["capacity_bytes"] = float("inf")
        return cls(**kw)


@dataclass
class HardwareSpec:
    """Complete machine description consumed by the simulator.

    ``topology`` accepts either a compiled :class:`Topology` or a
    declarative :class:`TopologySpec` (which is compiled on construction
    and kept in ``topology_spec`` for serialization). Specs built from a
    spec — including every preset — round-trip through JSON losslessly.
    """

    name: str
    topology: Topology
    tile: TileSpec
    dram: DRAMSpec
    # device ids (after flattening) that host a DRAM port; empty = every
    # device has local HBM (GPU/TPU style, no NoC traversal to reach DRAM).
    dram_ports: Tuple[int, ...] = ()
    precision_bytes: int = 2
    # scale-out fabric (repro_torch.fabric.FabricSpec) replicating the chip
    # described above into a board/node/cluster hierarchy; None = single
    # chip (every existing preset, bit-identical behaviour).
    fabric: Optional[Any] = None
    topology_spec: Optional[TopologySpec] = None
    _port_cache: Dict[int, Optional[int]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if isinstance(self.topology, TopologySpec):
            self.topology_spec = self.topology
            self.topology = self.topology.compile()
        elif self.topology_spec is None:
            # best effort: recover the spec from known compiled classes so
            # hand-built HardwareSpecs still serialize
            self.topology_spec = spec_of(self.topology)
        self.dram_ports = tuple(self.dram_ports)

    @property
    def num_chips(self) -> int:
        """Chips in the cluster (1 when no fabric is attached)."""
        return self.fabric.num_chips if self.fabric is not None else 1

    @property
    def chip_devices(self) -> int:
        """Devices on one chip (the compiled topology's grid)."""
        return self.topology.num_devices

    @property
    def num_devices(self) -> int:
        """Total devices across the cluster; global device ids are
        ``chip * chip_devices + local``."""
        return self.topology.num_devices * self.num_chips

    def nearest_dram_port(self, device: int) -> Optional[int]:
        if not self.dram_ports:
            return None
        port = self._port_cache.get(device)
        if port is None:
            port = min(self.dram_ports,
                       key=lambda p: self.topology.hops(device, p))
            self._port_cache[device] = port
        return port

    def with_(self, **kw) -> "HardwareSpec":
        if "topology" in kw and "topology_spec" not in kw:
            kw["topology_spec"] = None   # don't carry a stale spec
        return dataclasses.replace(self, **kw)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self.topology_spec is None:
            raise ValueError(
                f"hardware {self.name!r} has a custom {type(self.topology).__name__} "
                "topology with no declarative spec; build it from a TopologySpec "
                "to serialize")
        d = {
            "name": self.name,
            "topology": self.topology_spec.to_dict(),
            "tile": self.tile.to_dict(),
            "dram": self.dram.to_dict(),
            "dram_ports": list(self.dram_ports),
            "precision_bytes": self.precision_bytes,
        }
        if self.fabric is not None:
            d["fabric"] = self.fabric.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HardwareSpec":
        fabric = None
        if d.get("fabric") is not None:
            from ..fabric.spec import FabricSpec  # pure data, no cycle

            fabric = FabricSpec.from_dict(d["fabric"])
        try:
            return cls(
                name=d["name"],
                topology=topology_spec_from_dict(d["topology"]),
                tile=TileSpec.from_dict(d["tile"]),
                dram=DRAMSpec.from_dict(d["dram"]),
                dram_ports=tuple(d.get("dram_ports", ())),
                precision_bytes=d.get("precision_bytes", 2),
                fabric=fabric,
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"bad hardware dict: {e}") from None

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "HardwareSpec":
        return cls.from_dict(json.loads(s))


# --------------------------------------------------------------------------
# Presets used by the paper's case studies (all built from declarative
# topology specs, so `HardwareSpec.to_json()` works on every one of them)
# --------------------------------------------------------------------------

def grayskull() -> HardwareSpec:
    """Tenstorrent Grayskull e150 (paper Table I / §V-A3, [40]).

    120 Tensix cores in a 10x12 grid, ~368 int8 TOPS => ~3 TOPS/core,
    ~1 MB SRAM/core (120 MB total), 8 channels LPDDR4 ~100 GB/s aggregate,
    NoC ~192 GB/s per link direction.
    """
    spec = MeshSpec(rows=10, cols=12, intra_bw=192 * GB, link_latency=5e-8)
    # DRAM ports on the top edge (row 0), matching the board's 8 channels.
    ports = tuple(range(0, 12, 2))[:8]
    return HardwareSpec(
        name="grayskull",
        topology=spec,
        tile=TileSpec(flops=3.07 * TFLOPS, sram_bytes=1.0 * MB,
                      compute_efficiency=0.65, vector_efficiency=0.20),
        dram=DRAMSpec(bandwidth=100 * GB / 8, response_time=2e-7, channels=8),
        dram_ports=ports,
        precision_bytes=1,  # published numbers are int8
    )


def wafer_scale() -> HardwareSpec:
    """Paper Table VI wafer-scale config: 5x4 tiles of 4x4 cores.

    256 TFLOPS fp16 + 60 MB SRAM per *tile* => 16 TFLOPS + 3.75 MB per core.
    intra-tile NoC 1024 GB/s, inter-tile 256 GB/s, edge DRAM 256 GB/s/tile.
    """
    spec = HierarchicalSpec(
        tile=MeshSpec(rows=4, cols=4, intra_bw=1024 * GB, link_latency=2e-8),
        grid_rows=5, grid_cols=4, inter_bw=256 * GB)
    mesh = spec.flatten()
    # Edge-shared DRAM: one port per tile-row on both vertical edges.
    dev = lambda r, c: r * mesh.cols + c
    ports = tuple(dev(r, 0) for r in range(0, mesh.rows, 4)) + tuple(
        dev(r, mesh.cols - 1) for r in range(0, mesh.rows, 4))
    return HardwareSpec(
        name="wafer_scale",
        topology=spec,
        tile=TileSpec(flops=16 * TFLOPS, sram_bytes=3.75 * MB,
                      compute_efficiency=0.55, vector_efficiency=0.15),
        dram=DRAMSpec(bandwidth=256 * GB, response_time=3e-7, channels=10),
        dram_ports=ports,
        precision_bytes=2,
    )


def a100_cluster(num_gpus: int, d_model: Optional[int] = None) -> HardwareSpec:
    """Selene-style A100 cluster used for Table IV (Megatron published data).

    312 TFLOP/s bf16 peak. Sustained GEMM efficiency on A100 grows with
    matrix size (cuBLAS: ~52% at K~6k up to ~63% at K~20k — visible in
    Megatron's own per-GPU numbers, 135 TF/s @18B vs 163 TF/s @530B);
    ``d_model`` selects the point on that curve (also reachable from the
    CLI: ``--hardware a100x64 --d-model 12288``). 40 MB L2 as the "SRAM"
    level, 1.94 TB/s HBM2e local to each GPU (no NoC traversal =>
    dram_ports=()).
    """
    if d_model is None:
        eff = 0.52
    else:
        eff = min(0.65, max(0.45, 0.475 + 7.3e-6 * d_model))
    return HardwareSpec(
        name=f"a100x{num_gpus}",
        topology=GPUClusterSpec(num_gpus=num_gpus),
        tile=TileSpec(flops=312 * TFLOPS, sram_bytes=40 * MB,
                      compute_efficiency=eff, vector_efficiency=0.10),
        dram=DRAMSpec(bandwidth=1.94e12, response_time=1e-7, channels=num_gpus,
                      capacity_bytes=80e9),
        dram_ports=(),
        precision_bytes=2,
    )


def tpu_v5e_pod(rows: int = 16, cols: int = 16,
                torus: bool = False) -> HardwareSpec:
    """TPU v5e pod slice for the roofline cross-check (see DESIGN.md §3).

    197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s per ICI link. The real pod
    ICI is a 2-D torus; the default models it as a mesh (simulator routes
    are upper bounds on torus), ``torus=True`` adds the wraparound links
    (preset name ``tpu_v5e_torus`` / ``tpu_v5e_torus_<R>x<C>``).
    """
    spec = MeshSpec(rows=rows, cols=cols, intra_bw=50 * GB, link_latency=1e-6,
                    torus=torus)
    return HardwareSpec(
        name=f"tpu_v5e{'_torus' if torus else ''}_{rows}x{cols}",
        topology=spec,
        tile=TileSpec(flops=197 * TFLOPS, sram_bytes=128 * MB,
                      compute_efficiency=0.55, vector_efficiency=0.12),
        dram=DRAMSpec(bandwidth=819 * GB, response_time=1e-7, channels=rows * cols),
        dram_ports=(),
        precision_bytes=2,
    )


def tiled_cluster() -> HardwareSpec:
    """Four-chip cluster: 2 boards x 2 chips, each chip a 4x4 tiled
    accelerator with local HBM-style DRAM. The acceptance machine for the
    fabric subsystem — dp gradient all-reduces span chips and decompose
    into NoC legs + board/node fabric legs (hierarchical by default)."""
    from ..fabric.spec import cluster_2x2  # pure data, no cycle

    spec = MeshSpec(rows=4, cols=4, intra_bw=512 * GB, link_latency=2e-8)
    return HardwareSpec(
        name="tiled_cluster",
        topology=spec,
        tile=TileSpec(flops=16 * TFLOPS, sram_bytes=3.75 * MB,
                      compute_efficiency=0.55, vector_efficiency=0.15),
        dram=DRAMSpec(bandwidth=256 * GB, response_time=2e-7, channels=16),
        dram_ports=(),
        precision_bytes=2,
        fabric=cluster_2x2(),
    )


def tpu_v5e_torus_pod(rows: int = 16, cols: int = 16) -> HardwareSpec:
    """The tpu_v5e pod on the wraparound-ICI topology (MeshSpec torus)."""
    return tpu_v5e_pod(rows, cols, torus=True)


# name -> zero-arg builder; parameterized families (a100x<N>,
# tpu_v5e_<R>x<C>, tpu_v5e_torus_<R>x<C>) are parsed by
# repro.api.resolve_hardware on top of this registry.
HARDWARE_PRESETS = {
    "grayskull": grayskull,
    "wafer_scale": wafer_scale,
    "tpu_v5e": tpu_v5e_pod,
    "tpu_v5e_torus": tpu_v5e_torus_pod,
    "tiled_cluster": tiled_cluster,
}
