"""Topologies and their declarative specs (paper §II-C, §V-A2).

Two layers, mirroring ASTRA-sim-style hierarchical network descriptions:

* **Specs** — :class:`MeshSpec`, :class:`GPUClusterSpec`, and the
  two-level :class:`HierarchicalSpec` (a tile-level core grid composed
  over an inter-tile grid) are frozen dataclasses of pure data. They
  round-trip through ``to_dict``/``from_dict`` so a whole machine can be
  written as JSON, tweaked, and diffed, and :meth:`TopologySpec.compile`
  turns them into concrete topologies.

* **Compiled topologies** — :class:`Mesh2D`, :class:`Torus2D`,
  :class:`GPUCluster` implement the :class:`Topology` routing interface
  with **precomputed per-link bandwidth/latency arrays** and **memoized
  routing**: ``link_bandwidth``/``link_latency`` are O(1) array reads and
  ``route``/``hops``/``path_metrics`` are computed once per (src, dst)
  pair and cached. The NoC model's hot path (Eq. 2: latency sum +
  bottleneck bandwidth along a path) reads :meth:`Topology.path_metrics`
  instead of re-walking the route, which is what makes large detailed
  simulations fast (see ``benchmarks/bench_sim_scaling.py``). Pass
  ``cache_routing=False`` to recover the per-call baseline.

Routes returned by :meth:`Topology.route` are cached lists — treat them
as immutable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type

__all__ = [
    "Topology",
    "Mesh2D",
    "Torus2D",
    "GPUCluster",
    "TopologySpec",
    "MeshSpec",
    "GPUClusterSpec",
    "HierarchicalSpec",
    "topology_spec_from_dict",
    "spec_of",
]

GB = 1e9


# ---------------------------------------------------------------------------
# Compiled topologies (routing interface + caches)
# ---------------------------------------------------------------------------

class Topology:
    """Routing interface: a topology enumerates directed links and routes.

    Subclasses implement :meth:`_compute_route` plus the link-property
    lookups; the base class supplies route memoization and the cached
    ``path_metrics`` fast path consumed by the NoC model.
    """

    num_devices: int

    def __init__(self, cache_routing: bool = True):
        self.cache_routing = cache_routing
        self._route_cache: Dict[Tuple[int, int], List[int]] = {}
        # (src, dst) -> sorted de-duplicated link ids (the acquisition set)
        self._links_cache: Dict[Tuple[int, int], List[int]] = {}
        # (src, dst) -> (hops, latency_sum, bottleneck_bw)
        self._metric_cache: Dict[Tuple[int, int], Tuple[int, float, float]] = {}

    # -- to be implemented by subclasses -----------------------------------
    def _compute_route(self, src: int, dst: int) -> List[int]:
        raise NotImplementedError

    def num_links(self) -> int:
        raise NotImplementedError

    def link_bandwidth(self, link_id: int) -> float:
        raise NotImplementedError

    def link_latency(self, link_id: int) -> float:
        raise NotImplementedError

    def coords(self, device: int) -> Tuple[int, int]:
        raise NotImplementedError

    # -- cached routing ----------------------------------------------------
    def route(self, src: int, dst: int) -> List[int]:
        """Link ids traversed from ``src`` to ``dst`` (cached; don't mutate)."""
        if not self.cache_routing:
            return self._compute_route(src, dst)
        key = (src, dst)
        r = self._route_cache.get(key)
        if r is None:
            r = self._compute_route(src, dst)
            self._route_cache[key] = r
        return r

    def route_links(self, src: int, dst: int) -> List[int]:
        """Sorted, de-duplicated link ids of the src->dst route — the
        deadlock-free acquisition order (cached; don't mutate)."""
        if not self.cache_routing:
            return sorted(set(self._compute_route(src, dst)))
        key = (src, dst)
        r = self._links_cache.get(key)
        if r is None:
            r = sorted(set(self.route(src, dst)))
            self._links_cache[key] = r
        return r

    def path_metrics(self, src: int, dst: int) -> Tuple[int, float, float]:
        """(hops, latency_sum, bottleneck_bw) for the src->dst route.

        This is Eq. (2)'s per-path cost in one cached lookup; empty routes
        (src == dst) report infinite bandwidth so ``nbytes / bw`` is 0.
        """
        key = (src, dst)
        m = self._metric_cache.get(key)
        if m is None:
            r = self.route(src, dst)
            if r:
                m = (len(r),
                     sum(self.link_latency(l) for l in r),
                     min(self.link_bandwidth(l) for l in r))
            else:
                m = (0, 0.0, float("inf"))
            if self.cache_routing:
                self._metric_cache[key] = m
        return m

    def hops(self, src: int, dst: int) -> int:
        return self.path_metrics(src, dst)[0]


class Mesh2D(Topology):
    """2-D mesh with X-Y dimension-ordered routing.

    Two-level bandwidth: a hop whose endpoints lie in different *tiles*
    (``tile_shape`` groups of cores) uses ``inter_bw``; hops inside a tile
    use ``intra_bw``. With ``tile_shape=(1,1)`` it degenerates to a flat
    mesh (Grayskull-style single-level). Per-link bandwidth/latency are
    precomputed into arrays at construction.
    """

    def __init__(
        self,
        rows: int,
        cols: int,
        intra_bw: float,
        inter_bw: Optional[float] = None,
        link_latency: float = 5e-8,
        tile_shape: Tuple[int, int] = (1, 1),
        cache_routing: bool = True,
    ):
        super().__init__(cache_routing=cache_routing)
        self.rows, self.cols = rows, cols
        self.num_devices = rows * cols
        self.intra_bw = intra_bw
        self.inter_bw = intra_bw if inter_bw is None else inter_bw
        self._latency = link_latency
        self.tile_shape = tuple(tile_shape)
        # link id layout: horizontal links then vertical links, both directed.
        #   h-link (r, c, dir): between (r,c) and (r,c+1); dir 0 = east, 1 = west
        #   v-link (r, c, dir): between (r,c) and (r+1,c); dir 0 = south, 1 = north
        self._num_h = rows * (cols - 1) * 2
        self._num_v = (rows - 1) * cols * 2
        self._bw: List[float] = [self._endpoint_bw(*self._link_endpoints(l))
                                 for l in range(self.num_links())]

    # -- indexing -----------------------------------------------------------
    def device(self, r: int, c: int) -> int:
        return r * self.cols + c

    def coords(self, device: int) -> Tuple[int, int]:
        return divmod(device, self.cols)

    def _h_link(self, r: int, c: int, westward: bool) -> int:
        return (r * (self.cols - 1) + c) * 2 + int(westward)

    def _v_link(self, r: int, c: int, northward: bool) -> int:
        return self._num_h + (r * self.cols + c) * 2 + int(northward)

    def num_links(self) -> int:
        return self._num_h + self._num_v

    # -- routing --------------------------------------------------------------
    def _compute_route(self, src: int, dst: int) -> List[int]:
        (r0, c0), (r1, c1) = self.coords(src), self.coords(dst)
        links: List[int] = []
        c = c0
        while c < c1:
            links.append(self._h_link(r0, c, westward=False))
            c += 1
        while c > c1:
            links.append(self._h_link(r0, c - 1, westward=True))
            c -= 1
        r = r0
        while r < r1:
            links.append(self._v_link(r, c1, northward=False))
            r += 1
        while r > r1:
            links.append(self._v_link(r - 1, c1, northward=True))
            r -= 1
        return links

    # -- link properties -------------------------------------------------------
    def _link_endpoints(self, link_id: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        if link_id < self._num_h:
            base, westward = divmod(link_id, 2)
            r, c = divmod(base, self.cols - 1)
            return (r, c), (r, c + 1)
        base, northward = divmod(link_id - self._num_h, 2)
        r, c = divmod(base, self.cols)
        return (r, c), (r + 1, c)

    def _endpoint_bw(self, a: Tuple[int, int], b: Tuple[int, int]) -> float:
        (r0, c0), (r1, c1) = a, b
        tr, tc = self.tile_shape
        same_tile = (r0 // tr == r1 // tr) and (c0 // tc == c1 // tc)
        return self.intra_bw if same_tile else self.inter_bw

    def link_bandwidth(self, link_id: int) -> float:
        return self._bw[link_id]

    def link_latency(self, link_id: int) -> float:
        return self._latency


class Torus2D(Mesh2D):
    """2-D torus: a mesh plus wraparound links on every row and column.

    Extra link ids, after the mesh's horizontal+vertical blocks:

    * row wrap (r, dir):  ``dir 0`` = east wrap (r, cols-1) -> (r, 0),
      ``dir 1`` = west wrap (r, 0) -> (r, cols-1)
    * col wrap (c, dir):  ``dir 0`` = south wrap (rows-1, c) -> (0, c),
      ``dir 1`` = north wrap (0, c) -> (rows-1, c)

    Routing stays X-Y dimension-ordered but takes the shorter direction
    around each ring (ties go to the non-wrapping mesh direction), so a
    torus route never has more hops than the mesh route between the same
    pair.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._wrap_base = self._num_h + self._num_v
        self._num_wrap = 2 * self.rows + 2 * self.cols
        self._bw = [self._endpoint_bw(*self._link_endpoints(l))
                    for l in range(self.num_links())]

    def num_links(self) -> int:
        return self._num_h + self._num_v + getattr(self, "_num_wrap", 0)

    def _row_wrap(self, r: int, westward: bool) -> int:
        return self._wrap_base + 2 * r + int(westward)

    def _col_wrap(self, c: int, northward: bool) -> int:
        return self._wrap_base + 2 * self.rows + 2 * c + int(northward)

    def _link_endpoints(self, link_id: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        wrap_base = getattr(self, "_wrap_base", None)
        if wrap_base is None or link_id < wrap_base:
            return super()._link_endpoints(link_id)
        base = link_id - wrap_base
        if base < 2 * self.rows:
            r = base // 2
            return (r, 0), (r, self.cols - 1)
        c = (base - 2 * self.rows) // 2
        return (0, c), (self.rows - 1, c)

    def _compute_route(self, src: int, dst: int) -> List[int]:
        (r0, c0), (r1, c1) = self.coords(src), self.coords(dst)
        links: List[int] = []
        # X first: shorter way around the row ring (ties: the direct mesh
        # direction, which for c1 >= c0 is east and never wraps)
        d_east = (c1 - c0) % self.cols
        d_west = (c0 - c1) % self.cols
        c = c0
        if d_east < d_west or (d_east == d_west and c1 >= c0):
            for _ in range(d_east):
                links.append(self._row_wrap(r0, westward=False)
                             if c == self.cols - 1
                             else self._h_link(r0, c, westward=False))
                c = (c + 1) % self.cols
        else:
            for _ in range(d_west):
                links.append(self._row_wrap(r0, westward=True)
                             if c == 0
                             else self._h_link(r0, c - 1, westward=True))
                c = (c - 1) % self.cols
        # then Y along column c1 (same tie-break: direct mesh direction)
        d_south = (r1 - r0) % self.rows
        d_north = (r0 - r1) % self.rows
        r = r0
        if d_south < d_north or (d_south == d_north and r1 >= r0):
            for _ in range(d_south):
                links.append(self._col_wrap(c1, northward=False)
                             if r == self.rows - 1
                             else self._v_link(r, c1, northward=False))
                r = (r + 1) % self.rows
        else:
            for _ in range(d_north):
                links.append(self._col_wrap(c1, northward=True)
                             if r == 0
                             else self._v_link(r - 1, c1, northward=True))
                r = (r - 1) % self.rows
        return links


class GPUCluster(Topology):
    """Two-level GPU cluster: node switch (NVLink) + cluster switch (IB).

    Link ids: for each GPU g, links ``2g`` (up to node switch) and ``2g+1``
    (down). For each node n, links ``2G + 2n`` (node up to cluster) and
    ``2G + 2n + 1`` (down). Intra-node routes use only NVLink up/down;
    inter-node routes traverse NVLink up, NIC up, NIC down, NVLink down.
    """

    def __init__(
        self,
        num_gpus: int,
        gpus_per_node: int = 8,
        nvlink_bw: float = 300 * GB,     # A100 NVLink3 per direction
        nic_bw: float = 25 * GB,         # 8x200Gb/s HDR per node / 8 GPUs
        nvlink_latency: float = 2e-6,
        nic_latency: float = 5e-6,
        cache_routing: bool = True,
    ):
        super().__init__(cache_routing=cache_routing)
        self.num_devices = num_gpus
        self.gpus_per_node = gpus_per_node
        self.num_nodes = (num_gpus + gpus_per_node - 1) // gpus_per_node
        self.nvlink_bw, self.nic_bw = nvlink_bw, nic_bw
        self._nv_lat, self._nic_lat = nvlink_latency, nic_latency
        self._nvlink_cutoff = 2 * self.num_devices
        self._node_bw = nic_bw * gpus_per_node  # node NIC aggregate

    def coords(self, device: int) -> Tuple[int, int]:
        return divmod(device, self.gpus_per_node)  # (node, local rank)

    def num_links(self) -> int:
        return 2 * self.num_devices + 2 * self.num_nodes

    def _compute_route(self, src: int, dst: int) -> List[int]:
        if src == dst:
            return []
        n_src, n_dst = src // self.gpus_per_node, dst // self.gpus_per_node
        if n_src == n_dst:
            return [2 * src, 2 * dst + 1]
        base = self._nvlink_cutoff
        return [2 * src, base + 2 * n_src, base + 2 * n_dst + 1, 2 * dst + 1]

    def link_bandwidth(self, link_id: int) -> float:
        return self.nvlink_bw if link_id < self._nvlink_cutoff else self._node_bw

    def link_latency(self, link_id: int) -> float:
        return self._nv_lat if link_id < self._nvlink_cutoff else self._nic_lat


# ---------------------------------------------------------------------------
# Declarative specs
# ---------------------------------------------------------------------------

# kind tag -> spec class, for from_dict dispatch
_SPEC_KINDS: Dict[str, Type["TopologySpec"]] = {}


def _register(kind: str):
    def deco(cls):
        cls.kind = kind
        _SPEC_KINDS[kind] = cls
        return cls
    return deco


class TopologySpec:
    """Base for declarative topology descriptions (pure, JSON-able data)."""

    kind: str = ""

    def compile(self, cache_routing: bool = True) -> Topology:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TopologySpec":
        kw = {k: v for k, v in d.items() if k != "kind"}
        return cls(**kw)


@_register("mesh")
@dataclass(frozen=True)
class MeshSpec(TopologySpec):
    """2-D mesh (or torus, with ``torus=True``) of cores.

    ``tile_shape`` groups cores into tiles: hops crossing a tile boundary
    use ``inter_bw`` (defaults to ``intra_bw`` for a flat single-level
    mesh). Prefer :class:`HierarchicalSpec` to express the two levels
    compositionally.
    """

    rows: int
    cols: int
    intra_bw: float
    inter_bw: Optional[float] = None
    link_latency: float = 5e-8
    tile_shape: Tuple[int, int] = (1, 1)
    torus: bool = False

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"mesh shape {self.rows}x{self.cols} must be >= 1x1")
        tr, tc = self.tile_shape
        if self.rows % tr or self.cols % tc:
            raise ValueError(
                f"tile_shape {self.tile_shape} must divide mesh {self.rows}x{self.cols}")
        object.__setattr__(self, "tile_shape", tuple(self.tile_shape))

    @property
    def num_devices(self) -> int:
        return self.rows * self.cols

    def edge_devices(self, edge: str) -> Tuple[int, ...]:
        """Device ids along one mesh edge, in row/column order.

        ``edge`` is ``west`` (column 0), ``east`` (last column), ``north``
        (row 0) or ``south`` (last row) — the placement vocabulary for
        edge-shared DRAM ports (paper §IV-C ❸).
        """
        if edge == "west":
            return tuple(r * self.cols for r in range(self.rows))
        if edge == "east":
            return tuple(r * self.cols + self.cols - 1 for r in range(self.rows))
        if edge == "north":
            return tuple(range(self.cols))
        if edge == "south":
            return tuple((self.rows - 1) * self.cols + c for c in range(self.cols))
        raise ValueError(f"unknown edge {edge!r}; "
                         "expected west/east/north/south")

    def device_edges(self, device: int) -> Tuple[str, ...]:
        """Edges the device lies on (empty for interior devices; corners
        report both of their edges)."""
        r, c = divmod(device, self.cols)
        out = []
        if c == 0:
            out.append("west")
        if c == self.cols - 1:
            out.append("east")
        if r == 0:
            out.append("north")
        if r == self.rows - 1:
            out.append("south")
        return tuple(out)

    def compile(self, cache_routing: bool = True) -> Mesh2D:
        cls = Torus2D if self.torus else Mesh2D
        topo = cls(self.rows, self.cols, intra_bw=self.intra_bw,
                   inter_bw=self.inter_bw, link_latency=self.link_latency,
                   tile_shape=self.tile_shape, cache_routing=cache_routing)
        topo.spec = self
        return topo

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MeshSpec":
        kw = {k: v for k, v in d.items() if k != "kind"}
        if "tile_shape" in kw and kw["tile_shape"] is not None:
            kw["tile_shape"] = tuple(kw["tile_shape"])
        return cls(**kw)


@_register("gpu_cluster")
@dataclass(frozen=True)
class GPUClusterSpec(TopologySpec):
    """Fat two-level GPU cluster (§V-A2): NVLink inside a node, NIC across."""

    num_gpus: int
    gpus_per_node: int = 8
    nvlink_bw: float = 300 * GB
    nic_bw: float = 25 * GB
    nvlink_latency: float = 2e-6
    nic_latency: float = 5e-6

    def __post_init__(self):
        if self.num_gpus < 1 or self.gpus_per_node < 1:
            raise ValueError("num_gpus and gpus_per_node must be >= 1")

    @property
    def num_devices(self) -> int:
        return self.num_gpus

    def compile(self, cache_routing: bool = True) -> GPUCluster:
        topo = GPUCluster(self.num_gpus, gpus_per_node=self.gpus_per_node,
                          nvlink_bw=self.nvlink_bw, nic_bw=self.nic_bw,
                          nvlink_latency=self.nvlink_latency,
                          nic_latency=self.nic_latency,
                          cache_routing=cache_routing)
        topo.spec = self
        return topo


@_register("hierarchical")
@dataclass(frozen=True)
class HierarchicalSpec(TopologySpec):
    """Two-level tiled accelerator: a tile-level core grid composed over an
    inter-tile grid (paper Table VI; e.g. 5x4 tiles of 4x4 cores).

    ``tile`` describes one tile's internal mesh (``intra_bw`` + latency);
    the outer grid places ``grid_rows x grid_cols`` tiles whose boundary
    hops run at ``inter_bw``. Compiles to the flattened core mesh the
    simulator routes on (uniform X-Y routing, two-level bandwidth).

    .. deprecated::
        For hierarchies *above* one chip (board/node/cluster tiers with
        their own link budgets and collective algorithms) prefer a
        :class:`repro.fabric.FabricSpec` attached to
        ``HardwareSpec.fabric`` — it models the scale-out levels as
        switched links with real collective schedules instead of
        flattening them into one mesh. ``HierarchicalSpec`` remains the
        right tool for the on-die two-level NoC of paper Table VI.
    """

    tile: MeshSpec
    grid_rows: int
    grid_cols: int
    inter_bw: float
    torus: bool = False

    def __post_init__(self):
        if self.grid_rows < 1 or self.grid_cols < 1:
            raise ValueError("grid shape must be >= 1x1")
        if self.tile.torus or self.tile.tile_shape != (1, 1) \
                or self.tile.inter_bw is not None:
            raise ValueError("HierarchicalSpec.tile must be a flat mesh "
                             "(no torus / tile_shape / inter_bw of its own)")

    @property
    def num_devices(self) -> int:
        return self.grid_rows * self.tile.rows * self.grid_cols * self.tile.cols

    def flatten(self) -> MeshSpec:
        """The equivalent single flattened core mesh."""
        return MeshSpec(
            rows=self.grid_rows * self.tile.rows,
            cols=self.grid_cols * self.tile.cols,
            intra_bw=self.tile.intra_bw,
            inter_bw=self.inter_bw,
            link_latency=self.tile.link_latency,
            tile_shape=(self.tile.rows, self.tile.cols),
            torus=self.torus,
        )

    def compile(self, cache_routing: bool = True) -> Mesh2D:
        topo = self.flatten().compile(cache_routing=cache_routing)
        # override the flattened MeshSpec attachment: serialization must
        # round-trip the *hierarchical* description, not its flattening
        topo.spec = self
        return topo

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["tile"] = self.tile.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HierarchicalSpec":
        kw = {k: v for k, v in d.items() if k != "kind"}
        kw["tile"] = MeshSpec.from_dict(kw["tile"])
        return cls(**kw)


def topology_spec_from_dict(d: Dict[str, Any]) -> TopologySpec:
    """Rebuild a spec from its ``to_dict`` form, dispatching on ``kind``."""
    try:
        kind = d["kind"]
    except (TypeError, KeyError):
        raise ValueError(f"topology dict needs a 'kind' tag; got {d!r}") from None
    cls = _SPEC_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown topology kind {kind!r}; "
                         f"known: {sorted(_SPEC_KINDS)}")
    return cls.from_dict(d)


def spec_of(topo: Topology) -> Optional[TopologySpec]:
    """Recover the declarative spec of a compiled topology (None if the
    topology is a custom class the spec schema can't express).

    Topologies built by ``TopologySpec.compile`` carry their originating
    spec (``topo.spec``) and return it verbatim — this is what preserves
    a :class:`HierarchicalSpec` through serialization instead of
    degrading it to its flattened :class:`MeshSpec`. The structural
    fallbacks below handle hand-constructed topologies."""
    attached = getattr(topo, "spec", None)
    if isinstance(attached, TopologySpec):
        return attached
    if isinstance(topo, Mesh2D):          # Torus2D included
        return MeshSpec(rows=topo.rows, cols=topo.cols,
                        intra_bw=topo.intra_bw, inter_bw=topo.inter_bw,
                        link_latency=topo._latency,
                        tile_shape=tuple(topo.tile_shape),
                        torus=isinstance(topo, Torus2D))
    if isinstance(topo, GPUCluster):
        return GPUClusterSpec(num_gpus=topo.num_devices,
                              gpus_per_node=topo.gpus_per_node,
                              nvlink_bw=topo.nvlink_bw, nic_bw=topo.nic_bw,
                              nvlink_latency=topo._nv_lat,
                              nic_latency=topo._nic_lat)
    return None
