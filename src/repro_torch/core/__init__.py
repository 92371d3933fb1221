"""PALM core: event-driven performance simulator for tiled accelerators.

Paper: "PALM: A Efficient Performance Simulator for Tiled Accelerators
with Large-scale Model Training" (Fang et al., 2024). See
docs/simulator.md.

The port's copy of ``repro.core``: the event kernel,
the NoC/DRAM/SRAM models and the scalar fast tier are host code, as
there; the batched co-design tier (:mod:`.fastbatch`) replays its
signature groups on the card through the ``chain_replay`` kernel. A
hardware spec with a scale-out ``fabric`` simulates through
:mod:`repro_torch.fabric`, and ``metrics=True`` attaches
:mod:`repro_torch.obs`'s document. The planner (:mod:`.planner`) builds
on :mod:`repro_torch.api` and is imported on its own, as in the reference.
"""

from .enums import BoundaryMode, Layout, NoCMode, Schedule
from .events import AllOf, AnyOf, Environment, Event, PriorityResource, Process, Resource, Timeout
from .graph import (
    Attention,
    ComputationGraph,
    Conv2,
    Embedding,
    Linear,
    MoELayer,
    Norm,
    Op,
    Pool,
    SSMScan,
    TransformerLayer,
    bert_base_graph,
    resnet50_graph,
    transformer_lm_graph,
)
from .hardware import (
    DRAMSpec,
    GPUCluster,
    GPUClusterSpec,
    HARDWARE_PRESETS,
    HardwareSpec,
    HierarchicalSpec,
    Mesh2D,
    MeshSpec,
    TileSpec,
    Topology,
    TopologySpec,
    Torus2D,
    a100_cluster,
    grayskull,
    tpu_v5e_pod,
    wafer_scale,
)
from .topology import spec_of, topology_spec_from_dict
from .trace import (
    COMPUTE_KINDS,
    KIND_BD,
    KIND_DRAM,
    KIND_FD,
    KIND_GU,
    KIND_NOC,
    RESOURCE_KINDS,
    Trace,
    TraceDiff,
    TraceRecorder,
    TraceRow,
    chrome_trace,
)
from .trace import diff as trace_diff
from .noc import NoCModel, collective_steps, ring_time
from .dram import DRAMModel
from .parallelism import (
    BD,
    FD,
    GU,
    CommTask,
    MappedGraph,
    ParallelPlan,
    SplitOp,
    StageMapping,
    line_layout,
    make_groups,
    map_graph,
    s_shape_layout,
    split_op,
)
from .scheduler import PipelineSimulator, SimResult, ideal_pipeline_time
from .fastpath import (
    FastPathIneligible,
    StageChains,
    classify_cached,
    compile_stage_chains,
    replay_chains,
    try_fast_run,
)
from .fastbatch import run_fast_batch
from .simulator import PlanResult, simulate, sweep_plans
from .sram import OpAccess, StageMemory, allocate_stage, optimizer_state_bytes_per_param, stage_memory
