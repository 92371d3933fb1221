"""Declarative experiment spec — the canonical PALM front door.

An :class:`Experiment` names a workload (an arch-config registry entry or
an explicit :class:`ArchConfig` / :class:`ComputationGraph`), a hardware
spec (preset name, :class:`HardwareSpec`, or a ``--hardware-json`` file),
and either one fixed :class:`ParallelPlan` or a typed :class:`SearchSpace`
to sweep — optionally crossed with a :class:`HardwareSearchSpace` so one
sweep ranks hardware x parallelism points (the paper's §VI hardware
exploration). It validates eagerly — bad pp/dp/tp factorizations, unknown
schedules, or unsatisfiable batch settings fail before any simulation
starts — which is what makes thousand-point sweeps practical.

    from repro_torch.api import Experiment, SearchSpace, Schedule

    exp = Experiment(arch="yi-6b", hardware="wafer_scale",
                     search=SearchSpace(schedules=(Schedule.ONE_F_ONE_B,)),
                     global_batch=128, seq_len=2048)
    report = exp.sweep(workers=8)      # SweepReport, ranked best-first
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from ..configs import get_config
from ..configs.base import ArchConfig
from ..core.enums import BoundaryMode, Layout, NoCMode, Schedule
from ..core.graph import ComputationGraph
from ..core.hardware import (
    HARDWARE_PRESETS,
    GPUClusterSpec,
    HardwareSpec,
    HierarchicalSpec,
    MeshSpec,
    TopologySpec,
    a100_cluster,
    tpu_v5e_pod,
)
from ..core.parallelism import ParallelPlan
from ..core.workload import arch_to_graph
from ..serving.system import ServingSpec
from .report import RunReport, SweepReport

if TYPE_CHECKING:
    from .sweep import SweepEngine

__all__ = ["Experiment", "SearchSpace", "HardwareSearchSpace",
           "resolve_hardware", "HARDWARE_PRESETS"]


def resolve_hardware(hw: Union[str, HardwareSpec],
                     d_model: Optional[int] = None) -> HardwareSpec:
    """Accept a HardwareSpec or a preset name (``a100x<N>`` builds a GPU
    cluster of N devices, ``tpu_v5e_<R>x<C>`` a pod slice,
    ``tpu_v5e_torus_<R>x<C>`` the same slice with wraparound ICI links).

    ``d_model`` selects the point on the a100 sustained-GEMM efficiency
    curve (cuBLAS efficiency grows with matrix size); it is only
    meaningful for ``a100x<N>`` names.
    """
    if isinstance(hw, HardwareSpec):
        if d_model is not None:
            raise ValueError("d_model calibration applies to the a100x<N> "
                             "preset name, not an explicit HardwareSpec")
        return hw
    if not isinstance(hw, str):
        raise TypeError(f"hardware must be HardwareSpec or str, got {type(hw).__name__}")
    if hw.startswith("a100x"):
        try:
            return a100_cluster(int(hw[len("a100x"):]), d_model=d_model)
        except ValueError:
            pass
    if d_model is not None:
        raise ValueError(f"d_model calibration only applies to a100x<N>, "
                         f"not {hw!r}")
    if hw in HARDWARE_PRESETS:
        return HARDWARE_PRESETS[hw]()
    for prefix, torus in (("tpu_v5e_torus_", True), ("tpu_v5e_", False)):
        if hw.startswith(prefix):        # e.g. tpu_v5e_4x4, tpu_v5e_torus_4x4
            try:
                rows, cols = hw[len(prefix):].split("x")
                return tpu_v5e_pod(int(rows), int(cols), torus=torus)
            except ValueError:
                pass
    raise ValueError(f"unknown hardware preset {hw!r}; known: "
                     f"{sorted(HARDWARE_PRESETS) + ['a100x<N>', 'tpu_v5e_<R>x<C>', 'tpu_v5e_torus_<R>x<C>']}")


def _divisor_splits(n: int) -> List[Tuple[int, int, int]]:
    """(pp, dp, tp) triples with pp*dp*tp == n."""
    out = []
    for pp in (d for d in range(1, n + 1) if n % d == 0):
        rest = n // pp
        for dp in (d for d in range(1, rest + 1) if rest % d == 0):
            out.append((pp, dp, rest // dp))
    return out


@dataclass
class SearchSpace:
    """Typed sweep axes for parallelism search (§V-B).

    ``degrees`` fixes explicit (pp, dp, tp) triples; when ``None`` every
    divisor factorization of the device count is considered, filtered by
    arch shape (pp bounded by layer count, tp by head/feature count).
    ``interleave`` sweeps virtual-stage counts (interleaved 1F1B),
    ``zero_stages`` the ZeRO optimizer-sharding stage,
    ``comm_strategies`` the inter-tile-group boundary strategy (Fig. 11;
    only distinguishable under ``BoundaryMode.STRATEGY``), and
    ``activation_offload`` whether saved activations are parked off-device
    between FD and BD (smaller footprint, extra DRAM traffic — the
    pre-simulation memory-cap estimate accounts for it, so pruning stays
    exact).
    """

    degrees: Optional[Sequence[Tuple[int, int, int]]] = None
    schedules: Sequence[Schedule] = (Schedule.ONE_F_ONE_B,)
    layouts: Sequence[Layout] = (Layout.S_SHAPE, Layout.LINE)
    microbatch_sizes: Sequence[int] = (1, 2, 4)
    tp_contiguous: Sequence[bool] = (True,)
    interleave: Sequence[int] = (1,)
    zero_stages: Sequence[int] = (0,)
    comm_strategies: Sequence[int] = (1,)
    activation_offload: Sequence[bool] = (False,)
    max_plans: int = 64

    def __post_init__(self):
        self.schedules = tuple(Schedule(s) for s in self.schedules)
        self.layouts = tuple(Layout(l) for l in self.layouts)
        if self.max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        if any(b < 1 for b in self.microbatch_sizes):
            raise ValueError("microbatch sizes must be >= 1")
        if any(v < 1 for v in self.interleave):
            raise ValueError("interleave degrees must be >= 1")
        if any(z not in (0, 1, 2, 3) for z in self.zero_stages):
            raise ValueError("zero_stages must be in 0..3")
        if any(c not in (1, 2) for c in self.comm_strategies):
            raise ValueError("comm_strategies must be 1 or 2 (Fig. 11)")
        self.activation_offload = tuple(bool(v) for v in self.activation_offload)

    def enumerate_plans(self, hardware: HardwareSpec, global_batch: int,
                        training: bool = True,
                        arch: Optional[ArchConfig] = None) -> List[ParallelPlan]:
        """Materialize the plan list, arch-filtered and budget-pruned
        (diverse (pp, dp, tp) triples are kept first)."""
        n = hardware.num_devices
        triples = list(self.degrees) if self.degrees is not None else _divisor_splits(n)
        plans: List[ParallelPlan] = []
        for (pp, dp, tp) in triples:
            if pp * dp * tp > n:
                raise ValueError(
                    f"plan (pp={pp}, dp={dp}, tp={tp}) needs {pp * dp * tp} "
                    f"devices but {hardware.name} has {n}")
            if arch is not None:
                if pp > max(1, arch.num_layers):
                    continue
                if tp > max(arch.n_heads, arch.d_model // 64, 1):
                    continue
            for b in self.microbatch_sizes:
                if global_batch % (b * dp):
                    continue
                for sched in (self.schedules if training else (Schedule.GPIPE,)):
                    for layout in self.layouts:
                        for contig in self.tp_contiguous:
                            for virt in self.interleave:
                                if virt > 1 and pp == 1:
                                    continue   # interleaving needs a pipeline
                                if arch is not None and \
                                        pp * virt > max(1, arch.num_layers):
                                    continue
                                for zero in self.zero_stages:
                                    for strat in self.comm_strategies:
                                        for off in (self.activation_offload
                                                    if training else (False,)):
                                            plans.append(ParallelPlan(
                                                pp=pp, dp=dp, tp=tp, microbatch=b,
                                                global_batch=global_batch,
                                                schedule=sched, layout=layout,
                                                tp_contiguous=contig,
                                                interleave=virt, zero=zero,
                                                comm_strategy=strat,
                                                activation_offload=off,
                                                training=training))
        # budget: prefer diverse (pp, dp, tp) triples first
        seen, pruned = set(), []
        for p in plans:
            key = (p.pp, p.dp, p.tp)
            if key not in seen or len(pruned) < self.max_plans // 2:
                pruned.append(p)
                seen.add(key)
            if len(pruned) >= self.max_plans:
                break
        return pruned


# ---------------------------------------------------------------------------
# Hardware search space (§VI hardware exploration)
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    """Compact axis value for variant names: 16e12 -> '16T', 2.56e11 -> '256G'."""
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= scale:
            x = v / scale
            return (f"{x:.0f}" if x == int(x) else f"{x:g}") + suffix
    return f"{v:g}"


@dataclass
class HardwareSearchSpace:
    """Sweep axes over a base :class:`HardwareSpec` (tile compute/SRAM, NoC
    bandwidths, mesh shape, DRAM channels/bandwidth).

    Each axis left empty keeps the base value; the cartesian product of
    the provided axes (capped at ``max_specs``) is materialized as derived
    HardwareSpecs via the declarative topology specs, so topology axes
    (``intra_bw``/``inter_bw``/``mesh_shapes``) require the base topology
    to be a :class:`MeshSpec` or :class:`HierarchicalSpec`.

    When the mesh shape changes, edge DRAM ports are re-placed evenly
    along the *same edges* they occupy in the base layout (per-edge counts
    preserved, so two-edge layouts like ``wafer_scale``'s west+east
    columns stay two-edge); interior ports count toward the west edge.
    """

    tile_flops: Sequence[float] = ()
    sram_bytes: Sequence[float] = ()
    intra_bw: Sequence[float] = ()
    inter_bw: Sequence[float] = ()
    mesh_shapes: Sequence[Tuple[int, int]] = ()
    dram_channels: Sequence[int] = ()
    dram_bandwidth: Sequence[float] = ()
    # scale-out fabric axes (base hardware must carry a FabricSpec):
    # bandwidth of the outermost fabric level, and the cross-chip
    # collective family ("hierarchical"/"ring"/"tree"/"hd")
    fabric_bw: Sequence[float] = ()
    fabric_collectives: Sequence[str] = ()
    max_specs: int = 32

    def __post_init__(self):
        self.mesh_shapes = tuple((int(r), int(c)) for r, c in self.mesh_shapes)
        if self.max_specs < 1:
            raise ValueError("max_specs must be >= 1")
        from ..fabric.spec import COLLECTIVE_FAMILIES  # pure data, no cycle
        for fam in self.fabric_collectives:
            if fam not in COLLECTIVE_FAMILIES:
                raise ValueError(
                    f"unknown fabric collective {fam!r}; "
                    f"expected one of {COLLECTIVE_FAMILIES}")

    # axis name -> (values, variant-name tag, formatter)
    def _axes(self):
        return [
            ("tile_flops", self.tile_flops, "flops", _fmt),
            ("sram_bytes", self.sram_bytes, "sram", _fmt),
            ("intra_bw", self.intra_bw, "intra", _fmt),
            ("inter_bw", self.inter_bw, "inter", _fmt),
            ("mesh_shape", self.mesh_shapes, "mesh", lambda v: f"{v[0]}x{v[1]}"),
            ("dram_channels", self.dram_channels, "ch", str),
            ("dram_bandwidth", self.dram_bandwidth, "dram", _fmt),
            ("fabric_bw", self.fabric_bw, "fab", _fmt),
            ("fabric_collective", self.fabric_collectives, "coll", str),
        ]

    def enumerate_specs(self, base: HardwareSpec) -> List[HardwareSpec]:
        """Derived HardwareSpecs (cartesian product of the provided axes),
        capped at ``max_specs``."""
        axes = [(name, tuple(vals) or (None,), tag, fmt)
                for name, vals, tag, fmt in self._axes()]
        specs: List[HardwareSpec] = []
        for combo in itertools.product(*(vals for _, vals, _, _ in axes)):
            if len(specs) >= self.max_specs:
                break
            chosen = {name: v for (name, _, _, _), v in zip(axes, combo)
                      if v is not None}
            tags = [f"{tag}{fmt(chosen[name])}"
                    for name, _, tag, fmt in axes if name in chosen]
            specs.append(self._derive(base, chosen, tags))
        return specs

    def _derive(self, base: HardwareSpec, chosen: dict,
                tags: List[str]) -> HardwareSpec:
        tile = base.tile
        if "tile_flops" in chosen:
            tile = dataclasses.replace(tile, flops=chosen["tile_flops"])
        if "sram_bytes" in chosen:
            tile = dataclasses.replace(tile, sram_bytes=chosen["sram_bytes"])
        dram = base.dram
        if "dram_channels" in chosen:
            dram = dataclasses.replace(dram, channels=chosen["dram_channels"])
        if "dram_bandwidth" in chosen:
            dram = dataclasses.replace(dram, bandwidth=chosen["dram_bandwidth"])

        topo_axes = {k: chosen[k] for k in ("intra_bw", "inter_bw", "mesh_shape")
                     if k in chosen}
        topo_spec: Optional[TopologySpec] = base.topology_spec
        dram_ports = base.dram_ports
        if topo_axes:
            if topo_spec is None:
                raise ValueError(
                    f"hardware {base.name!r} has no declarative topology spec; "
                    "topology axes (intra_bw/inter_bw/mesh_shapes) need one")
            new_spec = self._mutate_topology(topo_spec, topo_axes)
            if "mesh_shape" in topo_axes and dram_ports:
                dram_ports = _replace_edge_ports(topo_spec, new_spec,
                                                 dram_ports)
            topo_spec = new_spec

        fabric = base.fabric
        fabric_axes = {k for k in ("fabric_bw", "fabric_collective")
                       if k in chosen}
        if fabric_axes:
            if fabric is None:
                raise ValueError(
                    f"hardware {base.name!r} has no fabric spec; fabric axes "
                    "(fabric_bw/fabric_collectives) need one")
            if "fabric_bw" in chosen:
                # the outermost level is the usual bottleneck — that's the
                # knob worth sweeping
                top = fabric.num_levels - 1
                fabric = fabric.with_level(top, bandwidth=chosen["fabric_bw"])
            if "fabric_collective" in chosen:
                fabric = dataclasses.replace(
                    fabric, collective=chosen["fabric_collective"])

        name = base.name + ("~" + "~".join(tags) if tags else "")
        return HardwareSpec(
            name=name,
            topology=topo_spec if topo_spec is not None else base.topology,
            tile=tile, dram=dram, dram_ports=dram_ports,
            precision_bytes=base.precision_bytes, fabric=fabric)

    @staticmethod
    def _mutate_topology(spec: TopologySpec, axes: dict) -> TopologySpec:
        if isinstance(spec, MeshSpec):
            kw = {}
            if "intra_bw" in axes:
                kw["intra_bw"] = axes["intra_bw"]
            if "inter_bw" in axes:
                kw["inter_bw"] = axes["inter_bw"]
            if "mesh_shape" in axes:
                kw["rows"], kw["cols"] = axes["mesh_shape"]
                tr, tc = spec.tile_shape
                if kw["rows"] % tr or kw["cols"] % tc:
                    # silently flattening to tile_shape (1,1) would turn every
                    # link into a slow inter-tile hop — refuse instead
                    raise ValueError(
                        f"mesh shape {kw['rows']}x{kw['cols']} does not divide "
                        f"the base tile_shape {spec.tile_shape}; pick divisible "
                        "shapes (or use a HierarchicalSpec base, where "
                        "mesh_shapes varies the inter-tile grid)")
            return dataclasses.replace(spec, **kw)
        if isinstance(spec, HierarchicalSpec):
            kw = {}
            if "intra_bw" in axes:
                kw["tile"] = dataclasses.replace(spec.tile,
                                                 intra_bw=axes["intra_bw"])
            if "inter_bw" in axes:
                kw["inter_bw"] = axes["inter_bw"]
            if "mesh_shape" in axes:
                # mesh_shape names the inter-tile grid for hierarchical specs
                kw["grid_rows"], kw["grid_cols"] = axes["mesh_shape"]
            return dataclasses.replace(spec, **kw)
        if isinstance(spec, GPUClusterSpec):
            kw = {}
            if "intra_bw" in axes:
                kw["nvlink_bw"] = axes["intra_bw"]
            if "inter_bw" in axes:
                kw["nic_bw"] = axes["inter_bw"]
            if "mesh_shape" in axes:
                raise ValueError("mesh_shapes does not apply to a GPU cluster; "
                                 "sweep hardware names (a100x<N>) instead")
            return dataclasses.replace(spec, **kw)
        raise ValueError(f"cannot sweep topology axes of {type(spec).__name__}")


# deterministic edge order for placement and tie-breaking
_EDGE_ORDER = ("west", "east", "north", "south")


def _flat_mesh(spec: TopologySpec) -> MeshSpec:
    return spec.flatten() if isinstance(spec, HierarchicalSpec) else spec


def _replace_edge_ports(base: TopologySpec, new: TopologySpec,
                        ports: Sequence[int]) -> Tuple[int, ...]:
    """Re-place DRAM ports on a re-shaped mesh, preserving the base
    layout's per-edge distribution.

    Each base port is attributed to the edge it lies on (corner ports go
    to whichever of their edges carries more ports overall, so e.g.
    ``wafer_scale``'s west+east columns stay a two-edge layout and
    ``grayskull``'s top row stays north); interior ports count toward the
    west edge. Each edge's ports are then spread evenly along the same
    edge of the new mesh, capped at the edge length.
    """
    base_mesh, new_mesh = _flat_mesh(base), _flat_mesh(new)
    membership = [base_mesh.device_edges(p) or ("west",) for p in ports]
    totals = {e: sum(e in m for m in membership) for e in _EDGE_ORDER}
    counts = dict.fromkeys(_EDGE_ORDER, 0)
    for edges in membership:
        best = max(edges, key=lambda e: (totals[e], -_EDGE_ORDER.index(e)))
        counts[best] += 1
    placed: Dict[int, None] = {}            # ordered, collision-free
    for edge in _EDGE_ORDER:
        devs = new_mesh.edge_devices(edge)
        k = min(counts[edge], len(devs))
        for i in range(k):
            want = (i * len(devs)) // k
            # a corner shared with an already-placed edge would silently
            # drop a port — slide to the nearest free device on this edge
            for offset in range(len(devs)):
                cand = devs[(want + offset) % len(devs)]
                if cand not in placed:
                    placed[cand] = None
                    break
    return tuple(placed)


@dataclass
class Experiment:
    """One declarative simulation/sweep spec. Exactly one of ``plan`` /
    ``search`` drives it: a fixed plan means :meth:`run`, a search space
    means :meth:`sweep`. Adding a ``hardware_search`` crosses either with
    hardware variants derived from ``hardware``."""

    arch: Union[str, ArchConfig, None] = None
    hardware: Union[str, HardwareSpec] = "wafer_scale"
    plan: Optional[ParallelPlan] = None
    search: Optional[SearchSpace] = None
    hardware_search: Optional[HardwareSearchSpace] = None
    graph_builder: Optional[Callable[[ParallelPlan], ComputationGraph]] = None
    seq_len: int = 2048
    global_batch: int = 256
    training: bool = True
    decode: bool = False                # serve-step graphs (1-token decode)
    noc_mode: NoCMode = NoCMode.MACRO
    boundary_mode: BoundaryMode = BoundaryMode.PAIRWISE
    memory_cap: Optional[float] = None  # bytes per tile; pre-sim feasibility
    # record NoC/DRAM busy-interval lanes into the trace (compute lanes are
    # always recorded); in sweeps this also implies return_timelines
    collect_timeline: bool = False
    # score candidates with the traffic-driven serving simulator instead
    # of one pipeline iteration: RunReport.throughput becomes SLO goodput
    # and the full ServingReport rides in RunReport.extra["serving"]
    serving: Optional[ServingSpec] = None
    # simulator tier (repro_torch.core.fastpath): "event" always runs the heap
    # kernel, "auto" takes the bit-identical closed-form fast tier when
    # the run is contention-free, "fast" demands it (raises otherwise).
    # A multi-fidelity rung's own ``engine`` overrides this per rung.
    engine: str = "event"
    # record repro_torch.obs metrics: sim-domain documents attach to every
    # RunReport (and a job-order aggregate + merged host registry to
    # SweepReport.metrics). Off by default — the disabled path is the
    # no-op registry and adds zero rows and zero overhead.
    metrics: bool = False

    def __post_init__(self):
        self.noc_mode = NoCMode(self.noc_mode)
        self.boundary_mode = BoundaryMode(self.boundary_mode)
        self.validate()

    # -- resolution ---------------------------------------------------------
    @property
    def arch_config(self) -> Optional[ArchConfig]:
        if self.arch is None:
            return None
        return get_config(self.arch) if isinstance(self.arch, str) else self.arch

    @functools.cached_property
    def hardware_spec(self) -> HardwareSpec:
        # cached: sweeps resolve the spec once per Experiment (per process),
        # not once per plan evaluation
        return resolve_hardware(self.hardware)

    @property
    def arch_name(self) -> str:
        cfg = self.arch_config
        return cfg.name if cfg is not None else "<custom graph>"

    def build_graph(self, plan: ParallelPlan) -> ComputationGraph:
        """Graph for one plan (per-iteration batch = microbatch * dp)."""
        if self.graph_builder is not None:
            return self.graph_builder(plan)
        return arch_to_graph(self.arch_config, self.seq_len,
                             plan.microbatch * plan.dp,
                             training=self.training, decode=self.decode)

    # -- validation ---------------------------------------------------------
    def validate(self) -> None:
        if self.plan is None and self.search is None:
            raise ValueError("Experiment needs a fixed `plan` or a `search` space")
        if self.plan is not None and self.search is not None:
            raise ValueError("Experiment takes `plan` or `search`, not both")
        if self.arch is None and self.graph_builder is None:
            raise ValueError("Experiment needs an `arch` (registry name or "
                             "ArchConfig) or a custom `graph_builder`")
        if isinstance(self.arch, str):
            get_config(self.arch)       # raises KeyError with known names
        hw = self.hardware_spec          # raises on unknown preset
        if self.plan is not None:
            p = self.plan
            need = p.pp * p.dp * p.tp
            if need > hw.num_devices:
                raise ValueError(
                    f"plan (pp={p.pp}, dp={p.dp}, tp={p.tp}) needs {need} "
                    f"devices but {hw.name} has {hw.num_devices}")
            if p.global_batch % (p.microbatch * p.dp):
                raise ValueError(
                    f"global_batch {p.global_batch} not divisible by "
                    f"microbatch*dp = {p.microbatch * p.dp}")
        if self.seq_len < 1 or self.global_batch < 1:
            raise ValueError("seq_len and global_batch must be >= 1")
        if self.engine not in ("event", "auto", "fast"):
            raise ValueError(f"unknown engine {self.engine!r} "
                             "(expected 'event', 'auto' or 'fast')")
        if self.serving is not None:
            if self.training:
                raise ValueError("serving experiments score decode traffic; "
                                 "set training=False")
            if self.arch is None:
                raise ValueError("serving experiments need an `arch` (the KV "
                                 "model derives from the ArchConfig)")

    # -- execution ----------------------------------------------------------
    def run(self) -> RunReport:
        """Simulate the fixed plan; returns a RunReport."""
        if self.plan is None:
            raise ValueError("run() needs a fixed plan; use sweep() for a search")
        from .sweep import run_one          # local import: sweep imports report
        return run_one(self, self.plan)

    def sweep(self, workers: int = 0,
              return_timelines: bool = False,
              strategy: Optional[str] = None,
              search_budget: Optional[int] = None,
              seed: Optional[int] = None,
              engine: Optional["SweepEngine"] = None,
              profile: bool = False,
              device=None) -> SweepReport:
        """Evaluate the search space; ``workers=0`` is serial, ``workers=N``
        uses an N-process pool, ``workers=None`` uses all cores. With a
        ``hardware_search``, the full (hardware variant x plan) product is
        flattened into one job stream evaluated by a single shared pool
        and the merged report ranks hardware x parallelism points.
        ``return_timelines=True`` ships each run's columnar event timeline
        back on ``RunReport.trace`` — and the full :class:`SimResult` on
        ``RunReport.sim`` — in compressed struct-of-arrays form (reports
        stay scalar by default).

        ``strategy`` selects guided search (:mod:`repro_torch.search`):
        ``"random"`` / ``"sh"`` / ``"evolve"`` evaluate only a budgeted
        subset of the space at full fidelity (``search_budget``, default
        a fifth of the space) and nest a :class:`SearchReport` into the
        result; ``None`` or ``"exhaustive"`` is the legacy exhaustive
        path, unchanged.

        ``engine`` lends an open (usually persistent, ``with``-entered)
        :class:`SweepEngine` whose warm process pool is reused instead of
        constructing one per call; it is used as-is and never closed, and
        its ``workers``/``return_timelines`` settings win over the
        same-named arguments here (see also
        :func:`repro_torch.api.sweep.shared_engine` for the module-level
        registry the planners use).

        Fast-path-eligible jobs (experiment/fidelity ``engine`` of
        ``"auto"`` or ``"fast"``) are priced through the vectorized
        batched fast tier (:mod:`repro_torch.core.fastbatch`) — bit-identical
        results, each chain-shape group replayed by ``chain_replay``
        launches on ``device``.
        ``profile=True`` attaches its per-phase accounting
        (compile/batch-eval/validate/fallback) to
        ``SweepReport.profile`` — for guided search the totals span every
        generation and a ``generations`` sub-list carries the per-rung
        deltas.

        ``device`` is where the batched tier replays its groups: ``None``
        means the card (a new engine raises without one), ``"cpu"`` the
        plain versions on the host. A lent ``engine`` keeps its own. A
        guided search's reduced rungs always take the fast tier."""
        return_timelines = return_timelines or self.collect_timeline
        if strategy not in (None, "exhaustive"):
            from ..search import run_search     # search builds on api
            return run_search(self, strategy=strategy, budget=search_budget,
                              seed=seed or 0, workers=workers,
                              return_timelines=return_timelines,
                              engine=engine, profile=profile, device=device)
        if search_budget is not None or seed is not None:
            # never let a "capped" sweep silently run the whole product
            raise ValueError("search_budget/seed only apply to guided "
                             "search; pass strategy='random'/'sh'/'evolve'")
        if self.hardware_search is not None:
            return self._sweep_hardware(workers, return_timelines, engine,
                                        profile=profile, device=device)
        if self.search is None:
            if self.plan is not None:   # degenerate single-point sweep
                plans = [self.plan]
            else:
                raise ValueError("sweep() needs a `search` space")
        else:
            plans = self.search.enumerate_plans(
                self.hardware_spec, self.global_batch,
                training=self.training, arch=self.arch_config)
        from .sweep import SweepEngine
        eng = engine if engine is not None else SweepEngine(
            workers=workers, return_timelines=return_timelines,
            trace_resources=self.collect_timeline, profile=profile,
            device=device)
        return eng.sweep(self, plans)

    def _hardware_label(self, num_hardware: int) -> str:
        """Report hardware name: the base spec for single-machine sweeps,
        a variant-count label for hardware x plan sweeps."""
        base = self.hardware_spec
        return (base.name if num_hardware == 1
                else f"{base.name} (x{num_hardware} hardware variants)")

    def _record_hardware_specs(self, report: SweepReport,
                               specs: Sequence[HardwareSpec]) -> None:
        """Store each kept variant's spec dict on the report so the
        winning machine is recoverable from the report alone."""
        for spec in specs:
            try:
                # normalize through JSON (tuples -> lists) so stored dicts
                # compare equal across a report to_json/from_json round-trip
                report.hardware_specs[spec.name] = json.loads(spec.to_json())
            except ValueError:
                pass        # custom topology without a declarative spec

    def _plans_for(self, spec: HardwareSpec) -> List[ParallelPlan]:
        """Plan list for one hardware variant (raises ValueError when the
        variant cannot host the fixed plan / explicit search degrees)."""
        if self.search is not None:
            return self.search.enumerate_plans(
                spec, self.global_batch,
                training=self.training, arch=self.arch_config)
        # fixed plan: reuse Experiment validation against this variant
        self.with_(hardware=spec, hardware_search=None)
        return [self.plan]

    def _sweep_hardware(self, workers: int,
                        return_timelines: bool = False,
                        engine: Optional["SweepEngine"] = None,
                        profile: bool = False,
                        device=None) -> SweepReport:
        """Merged hardware x plan sweep: flatten every variant's plan list
        into one (variant, plan) job stream and evaluate it through one
        shared process pool (workers are initialized once with all variant
        specs; each worker's graph memo is shared across variants)."""
        from .sweep import Job, SweepEngine
        base = self.hardware_spec
        specs = self.hardware_search.enumerate_specs(base)
        kept: List[HardwareSpec] = []
        jobs: List[Job] = []
        failed = 0
        for spec in specs:
            try:
                # a variant can be too small for a fixed plan or for explicit
                # search degrees — count it failed, keep the other variants
                plans = self._plans_for(spec)
            except ValueError:
                failed += 1
                continue
            jobs.extend((len(kept), p) for p in plans)
            kept.append(spec)
        if engine is None:
            engine = SweepEngine(workers=workers,
                                 return_timelines=return_timelines,
                                 trace_resources=self.collect_timeline,
                                 profile=profile, device=device)
        report = engine.sweep_jobs(
            self, kept, jobs,
            hardware_name=self._hardware_label(len(specs)),
            num_hardware=len(specs),
            extra_failed=failed)
        self._record_hardware_specs(report, kept)
        return report

    def with_(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)
