"""The port's Experiment API (``repro_torch.api``) and planners
(``repro_torch.core.planner``) against the reference's (``repro.api``,
``repro.core.planner``): each case builds the same experiment in both
packages and asks for exact equality — reports as JSON, traces as bytes,
errors by type and message — on the serial path with the event and the
batched ("auto") tiers, and for the port alone serial against the spawned
pool. The mirrored tests are ``tests/test_api.py`` and
``tests/test_system.py``'s two planner tests (guided search has its own
file, ``tests/test_torch_search.py``). Then the port's own rules: only an
error of the batch's host compile re-runs its jobs on the host (a
refusal of ``chain_replay`` or an error of the device replay leaves the
sweep), a sweep runs nowhere but on the card unless ``device="cpu"``
asks for it, and the exhaustive planners, which never batch, are host
code. The port's batched tier replays on the CPU here
(``device="cpu"``)."""

import importlib
import json
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.serving.planner as R_serving_planner  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro.core.hardware import tiled_cluster as R_tiled_cluster  # noqa: E402

import repro_torch.api as TA  # noqa: E402
import repro_torch.api.sweep as T_sweep  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.core.fastbatch as T_fastbatch  # noqa: E402
import repro_torch.serving.planner as T_serving_planner  # noqa: E402
from repro_torch.configs import get_config as T_get_config  # noqa: E402
from repro_torch.core.hardware import tiled_cluster as T_tiled_cluster  # noqa: E402
from repro_torch.serving.planner import plan_serving as T_plan_serving  # noqa: E402

# the module: ``repro_torch.kernels`` binds the name ``chain_replay`` to the wrapper
T_chain_replay = importlib.import_module("repro_torch.kernels.chain_replay")
T_build = importlib.import_module("repro_torch.kernels.build")

from torch_core_common import assert_same_result  # noqa: E402

REF = SimpleNamespace(api=RA, core=RC, get_config=R_get_config, tiled_cluster=R_tiled_cluster,
                      planner=R_serving_planner, dev={})
PORT = SimpleNamespace(api=TA, core=TC, get_config=T_get_config, tiled_cluster=T_tiled_cluster,
                       planner=T_serving_planner, dev={"device": "cpu"})
SIDES = (REF, PORT)


def _doc(report):
    """A report's JSON without what is wall clock: the batched tier's
    profile and the host half of a metrics document."""
    d = report.to_dict()
    d.pop("profile", None)
    if isinstance(d.get("metrics"), dict):
        d["metrics"].pop("host", None)
    return json.dumps(d, sort_keys=True)


def _same_runs(a, b):
    """Two sweep reports equal as JSON, and each run's shipped trace (and
    its SimResult's) equal byte for byte."""
    assert _doc(a) == _doc(b)
    for ra, rb in zip(a.runs, b.runs):
        assert (ra.trace is None) == (rb.trace is None)
        if ra.trace is not None:
            assert ra.trace.to_bytes() == rb.trace.to_bytes()
        assert (ra.sim is None) == (rb.sim is None)
        if ra.sim is not None:
            assert_same_result(ra.sim, rb.sim)


def _error(fn):
    """(type name, message) of what ``fn()`` raises."""
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value).__name__, str(err.value)


# ---------------------------------------------------------------------------
# typed enums and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,raw,member", [
    ("Schedule", "1f1b", "ONE_F_ONE_B"),
    ("Schedule", "gpipe", "GPIPE"),
    ("Layout", "s_shape", "S_SHAPE"),
    ("Layout", "line", "LINE"),
    ("NoCMode", "macro", "MACRO"),
    ("BoundaryMode", "strategy", "STRATEGY"),
])
def test_enum_constructs_from_canonical_value_silently(cls, raw, member):
    for side in SIDES:
        enum = getattr(side.api, cls)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert enum(raw) is getattr(enum, member)
            assert enum(getattr(enum, member)) is getattr(enum, member)
    assert [m.value for m in getattr(TA, cls)] == [m.value for m in getattr(RA, cls)]


@pytest.mark.parametrize("bad", ["one_f_one_b", "GPIPE", "2f2b", ""])
def test_enum_rejects_non_canonical_strings(bad):
    ref, port = (_error(lambda s=side: s.api.Schedule(bad)) for side in SIDES)
    assert port == ref and "unknown Schedule" in port[1]


def test_parallel_plan_is_strictly_typed():
    plans = []
    for side in SIDES:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plan = side.api.ParallelPlan(schedule=side.api.Schedule.GPIPE,
                                         layout=side.api.Layout.LINE)
        assert plan.schedule is side.api.Schedule.GPIPE and plan.schedule == "gpipe"
        plans.append(side.api.plan_to_dict(plan))
    assert plans[0] == plans[1]
    assert _error(lambda: TA.ParallelPlan(schedule="2f2b")) == \
        _error(lambda: RA.ParallelPlan(schedule="2f2b"))


def test_simulate_accepts_canonical_mode_without_warning():
    res = []
    for side in SIDES:
        g = side.core.transformer_lm_graph("t", 2, 128, 4, seq_len=64, batch=1, vocab=256)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            res.append(side.core.simulate(g, side.core.tpu_v5e_pod(2, 2),
                                          side.api.ParallelPlan(global_batch=2),
                                          noc_mode="macro"))
    assert res[1].throughput > 0
    assert_same_result(*res)


# ---------------------------------------------------------------------------
# validation: the same error, word for word
# ---------------------------------------------------------------------------

def _tiny(side, **kw):
    defaults = dict(arch="yi-6b", hardware=side.core.tpu_v5e_pod(2, 2), seq_len=128,
                    global_batch=8)
    defaults.update(kw)
    return side.api.Experiment(**defaults)


def _serving_spec(side, **kw):
    from importlib import import_module
    system = import_module(side.api.__name__.split(".")[0] + ".serving.system")
    workload = import_module(side.api.__name__.split(".")[0] + ".serving.workload")
    return system.ServingSpec(workload=workload.WorkloadSpec(rate=2.0, num_requests=10, seed=3,
                                                             prompt_mean=64, decode_mean=8,
                                                             prompt_cv=0.5, decode_cv=0.5),
                              max_batch=4, ctx_bucket=128, **kw)


def _bare_mesh_spec(side):
    return side.api.HardwareSpec(
        name="t", topology=side.api.MeshSpec(8, 8, intra_bw=1e12, inter_bw=2.5e11,
                                             tile_shape=(4, 4)),
        tile=side.core.TileSpec(flops=1e12, sram_bytes=1e6),
        dram=side.core.DRAMSpec(bandwidth=1e11))


INVALID = {
    "needs plan or search": lambda s: s.api.Experiment(arch="yi-6b"),
    "plan and search": lambda s: s.api.Experiment(arch="yi-6b", plan=s.api.ParallelPlan(),
                                                  search=s.api.SearchSpace()),
    "factorization": lambda s: _tiny(s, plan=s.api.ParallelPlan(pp=2, dp=2, tp=2,
                                                               global_batch=4)),
    "batch split": lambda s: _tiny(s, plan=s.api.ParallelPlan(pp=1, dp=2, tp=2, microbatch=2,
                                                             global_batch=6)),
    "unknown arch": lambda s: s.api.Experiment(arch="not-a-model", plan=s.api.ParallelPlan()),
    "unknown hardware": lambda s: s.api.Experiment(arch="yi-6b", hardware="cerebras-42",
                                                   plan=s.api.ParallelPlan()),
    "unknown engine": lambda s: _tiny(s, plan=s.api.ParallelPlan(global_batch=8),
                                      engine="warp"),
    "oversubscribed degrees": lambda s: s.api.SearchSpace(degrees=[(2, 2, 2)]).enumerate_plans(
        s.core.tpu_v5e_pod(2, 2), global_batch=8),
    "zero_stages": lambda s: s.api.SearchSpace(zero_stages=(4,)),
    "comm_strategies": lambda s: s.api.SearchSpace(comm_strategies=(3,)),
    "interleave": lambda s: s.api.SearchSpace(interleave=(0,)),
    "d_model on a preset": lambda s: s.api.resolve_hardware("wafer_scale", d_model=4096),
    "undivisible mesh": lambda s: s.api.HardwareSearchSpace(
        mesh_shapes=((5, 5),)).enumerate_specs(_bare_mesh_spec(s)),
    "serving needs inference": lambda s: s.api.Experiment(
        arch="hymba-1.5b", hardware="grayskull", search=s.api.SearchSpace(max_plans=1),
        serving=_serving_spec(s)),
    "run needs a plan": lambda s: _tiny(s, search=s.api.SearchSpace()).run(),
    "budget without a strategy": lambda s: _tiny(s, search=s.api.SearchSpace()).sweep(
        search_budget=2, **s.dev),
    "codesign needs hardware axes": lambda s: s.api.plan_codesign(
        s.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2), s.api.PlannerCfg()),
    "planner budget without a strategy": lambda s: s.api.plan_parallelism(
        s.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2),
        s.api.PlannerCfg(global_batch=8, seq_len=128, max_plans=1, search_budget=2)),
    "unknown objective": lambda s: s.api.plan_parallelism(
        s.get_config("yi-6b"), None, s.api.PlannerCfg(), objective="latency"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_input_raises_as_the_reference(case):
    ref, port = (_error(lambda s=side: INVALID[case](s)) for side in SIDES)
    assert port == ref
    assert port[0] in ("ValueError", "KeyError")


@pytest.mark.parametrize("name", ["grayskull", "wafer_scale", "a100x16", "tpu_v5e_2x2",
                                  "tpu_v5e_2x4", "tpu_v5e_torus", "tpu_v5e_torus_2x4",
                                  "tiled_cluster"])
def test_resolve_hardware_presets_equal_reference(name):
    ref, port = (side.api.resolve_hardware(name) for side in SIDES)
    assert port.to_json() == ref.to_json()
    assert type(port.topology).__name__ == type(ref.topology).__name__
    assert TA.HardwareSpec.from_json(port.to_json()).to_dict() == port.to_dict()


def test_resolve_hardware_d_model_calibration():
    lo, hi = (TA.resolve_hardware("a100x8", d_model=d) for d in (4096, 20480))
    assert hi.tile.compute_efficiency > lo.tile.compute_efficiency
    assert hi.to_json() == RA.resolve_hardware("a100x8", d_model=20480).to_json()
    assert TA.resolve_hardware("grayskull").name == "grayskull"
    assert TA.resolve_hardware("a100x16").num_devices == 16


def test_tpu_v5e_torus_routes_no_longer_than_mesh():
    mesh = TA.resolve_hardware("tpu_v5e_4x4").topology
    torus = TA.resolve_hardware("tpu_v5e_torus_4x4").topology
    ref = RA.resolve_hardware("tpu_v5e_torus_4x4").topology
    for src in range(16):
        for dst in range(16):
            assert torus.hops(src, dst) <= mesh.hops(src, dst)
            assert torus.hops(src, dst) == ref.hops(src, dst)


# ---------------------------------------------------------------------------
# search spaces
# ---------------------------------------------------------------------------

PLAN_SPACES = {
    "interleave zero comm": (dict(degrees=[(2, 2, 1)], microbatch_sizes=(1,),
                                  layouts=("s_shape",), interleave=(1, 2), zero_stages=(0, 2),
                                  comm_strategies=(1, 2), max_plans=64), 8),
    "interleave needs pp": (dict(degrees=[(1, 4, 1)], microbatch_sizes=(1,),
                                 layouts=("s_shape",), interleave=(1, 2)), 8),
    "all splits": (dict(max_plans=48, microbatch_sizes=(1, 2, 4),
                        tp_contiguous=(True, False)), 16),
}


@pytest.mark.parametrize("space", sorted(PLAN_SPACES))
def test_search_space_enumerates_the_reference_plans(space):
    kw, batch = PLAN_SPACES[space]
    ref, port = ([side.api.plan_to_dict(p) for p in side.api.SearchSpace(**kw).enumerate_plans(
        side.core.tpu_v5e_pod(2, 2), global_batch=batch, training=True,
        arch=side.get_config("yi-6b"))] for side in SIDES)
    assert port == ref and port
    if space == "interleave zero comm":
        assert len(port) == 8 and {p["interleave"] for p in port} == {1, 2}
    if space == "interleave needs pp":
        assert {p["interleave"] for p in port} == {1}


def _dram_mixed(side):
    return side.core.hardware.HardwareSpec(
        name="mixed", topology=side.api.MeshSpec(4, 4, intra_bw=1e12),
        tile=side.core.TileSpec(flops=1e12, sram_bytes=1e6),
        dram=side.core.DRAMSpec(bandwidth=1e11, channels=5), dram_ports=(0, 4, 8, 1, 2))


HW_SPACES = {
    "flops x intra bw": (lambda s: s.core.tpu_v5e_pod(2, 2),
                         dict(tile_flops=(100e12, 197e12), intra_bw=(25e9, 50e9))),
    "grayskull mesh": (lambda s: s.core.grayskull(), dict(mesh_shapes=((6, 6),))),
    "wafer mesh": (lambda s: s.core.wafer_scale(), dict(mesh_shapes=((4, 4),))),
    "corner collisions": (_dram_mixed, dict(mesh_shapes=((4, 4),))),
}


@pytest.mark.parametrize("space", sorted(HW_SPACES))
def test_hardware_search_space_enumerates_the_reference_specs(space):
    base, kw = HW_SPACES[space]
    ref, port = ([v.to_json() for v in side.api.HardwareSearchSpace(**kw).enumerate_specs(
        base(side))] for side in SIDES)
    assert port == ref
    specs = TA.HardwareSearchSpace(**kw).enumerate_specs(base(PORT))
    assert len({s.name for s in specs}) == len(specs)
    if space == "grayskull mesh":
        (spec,) = specs
        mesh = spec.topology_spec
        assert spec.num_devices == 36 and len(spec.dram_ports) == 6
        assert all("north" in mesh.device_edges(p) for p in spec.dram_ports)
    if space == "corner collisions":
        assert len(set(specs[0].dram_ports)) == 5


# ---------------------------------------------------------------------------
# runs and sweeps, serial, against the reference
# ---------------------------------------------------------------------------

def test_run_report_json_round_trip():
    ref, port = (_tiny(side, plan=side.api.ParallelPlan(pp=2, dp=2, tp=1,
                                                        global_batch=8)).run()
                 for side in SIDES)
    assert port.to_json() == ref.to_json()
    back = TA.RunReport.from_json(port.to_json())
    assert back == port and back.plan.schedule is TA.Schedule.ONE_F_ONE_B


def _hw_cross(side, **kw):
    defaults = dict(search=side.api.SearchSpace(max_plans=4, microbatch_sizes=(1, 2)),
                    hardware_search=side.api.HardwareSearchSpace(
                        tile_flops=(100e12, 197e12), dram_bandwidth=(400e9, 819e9)))
    defaults.update(kw)
    return _tiny(side, **defaults)


# name -> (experiment for a side, sweep keyword arguments)
SWEEPS = {
    "plain": (lambda s, e: _tiny(s, engine=e, search=s.api.SearchSpace(
        max_plans=6, microbatch_sizes=(1, 2))), {}),
    "one layout": (lambda s, e: _tiny(s, engine=e, search=s.api.SearchSpace(
        max_plans=4, microbatch_sizes=(1,), layouts=(s.api.Layout.S_SHAPE,))), {}),
    "timelines": (lambda s, e: _tiny(s, engine=e, search=s.api.SearchSpace(
        max_plans=4, microbatch_sizes=(1,), layouts=(s.api.Layout.S_SHAPE,))),
        {"return_timelines": True}),
    "extended axes": (lambda s, e: _tiny(s, engine=e, global_batch=16, search=s.api.SearchSpace(
        degrees=[(2, 2, 1), (2, 1, 2)], microbatch_sizes=(1, 2), interleave=(1, 2),
        zero_stages=(0, 1), max_plans=64)), {}),
    "hardware cross": (lambda s, e: _hw_cross(s, engine=e), {}),
    "hardware cross timelines": (lambda s, e: _hw_cross(
        s, engine=e, search=s.api.SearchSpace(max_plans=3, microbatch_sizes=(1,),
                                              layouts=(s.api.Layout.S_SHAPE,)),
        hardware_search=s.api.HardwareSearchSpace(tile_flops=(100e12, 197e12))),
        {"return_timelines": True}),
    "oversubscribed variant": (lambda s, e: _tiny(s, engine=e, search=s.api.SearchSpace(
        degrees=[(2, 2, 1)], microbatch_sizes=(1,), layouts=(s.api.Layout.S_SHAPE,)),
        hardware_search=s.api.HardwareSearchSpace(mesh_shapes=((2, 2), (1, 2)))), {}),
    "memory pruned": (lambda s, e: _tiny(s, engine=e, memory_cap=1e6, search=s.api.SearchSpace(
        max_plans=3, microbatch_sizes=(1,))), {}),
    "fabric timelines": (lambda s, e: s.api.Experiment(
        arch="yi-6b", hardware=s.tiled_cluster(), seq_len=128, global_batch=8, engine=e,
        collect_timeline=True, search=s.api.SearchSpace(
            degrees=((2, 8, 4), (4, 4, 4)), microbatch_sizes=(1,),
            layouts=(s.api.Layout.S_SHAPE,))), {"return_timelines": True}),
    "metrics": (lambda s, e: _tiny(s, engine=e, metrics=True, search=s.api.SearchSpace(
        degrees=[(2, 1, 2), (1, 2, 2), (2, 2, 1)], microbatch_sizes=(1, 2))), {}),
}


@pytest.mark.parametrize("engine", ["event", "auto"])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_serial_sweep_equals_reference(name, engine):
    build, kw = SWEEPS[name]
    ref, port = (build(side, engine).sweep(workers=0, **kw, **side.dev) for side in SIDES)
    assert port.runs or name == "memory pruned"
    _same_runs(ref, port)
    back = TA.SweepReport.from_json(port.to_json())
    assert back == port and back.hardware_specs == port.hardware_specs
    if name == "memory pruned":
        assert port.num_pruned_memory == len(port.pruned_records) > 0
        assert back.pruned_records == port.pruned_records
    if name == "hardware cross":
        spec = TA.HardwareSpec.from_dict(port.best_hardware_dict())
        assert spec.name == port.best.hardware and port.num_hardware == 4
    if name == "oversubscribed variant":
        assert port.num_failed == 1 and all("2x2" in r.hardware for r in port.runs)
    if name == "metrics":
        assert port.metrics["host"]["counters"]["host.sweep.jobs"] == port.num_candidates
        assert TA.SweepReport.from_json(port.to_json()).metrics == port.metrics
    if kw.get("return_timelines"):
        assert all(r.sim is not None and r.trace is not None for r in port.runs)


def test_memory_cap_prunes_before_simulation():
    exp = _tiny(PORT, search=TA.SearchSpace(max_plans=6, microbatch_sizes=(1, 2)))
    base = exp.sweep(device="cpu")
    mems = sorted(r.peak_memory_bytes for r in base.runs)
    cap = mems[len(mems) // 2]
    capped = exp.with_(memory_cap=cap).sweep(device="cpu")
    assert capped.num_pruned_memory > 0
    assert [r.plan for r in capped.runs] == \
        [r.plan for r in base.runs if r.peak_memory_bytes <= cap]
    ref = _tiny(REF, memory_cap=cap, search=RA.SearchSpace(max_plans=6,
                                                          microbatch_sizes=(1, 2))).sweep()
    assert capped.to_json() == ref.to_json()


def test_sweep_engine_matches_legacy_sweep_plans():
    exp = _tiny(PORT, global_batch=16, search=TA.SearchSpace(
        max_plans=48, microbatch_sizes=(1, 2, 4), tp_contiguous=(True, False)))
    plans = exp.search.enumerate_plans(exp.hardware_spec, exp.global_batch, training=True,
                                       arch=exp.arch_config)
    assert len(plans) >= 24
    legacy = TC.sweep_plans(exp.build_graph, exp.hardware_spec, plans,
                            noc_mode=TA.NoCMode.MACRO)
    engine = TA.SweepEngine(workers=0, device="cpu").sweep(exp, plans)
    assert [r.plan for r in legacy] == [r.plan for r in engine.runs]
    assert [r.throughput for r in legacy] == [r.throughput for r in engine.runs]


def test_graph_builder_experiments_sweep_serially():
    reps = []
    for side in SIDES:
        core = side.core
        exp = side.api.Experiment(
            graph_builder=lambda p, core=core: core.transformer_lm_graph(
                "t", 2, 128, 4, seq_len=64, batch=p.microbatch * p.dp, vocab=256),
            hardware=core.tpu_v5e_pod(2, 2),
            search=side.api.SearchSpace(max_plans=3, microbatch_sizes=(1,),
                                        layouts=(side.api.Layout.S_SHAPE,)),
            global_batch=4)
        with pytest.warns(RuntimeWarning, match="not picklable"):
            reps.append(exp.sweep(workers=2, **side.dev))
    assert reps[1].runs and reps[1].executor == "serial"
    assert reps[1].to_json() == reps[0].to_json()


# ---------------------------------------------------------------------------
# the spawned pool: equal to the serial sweep, bit for bit
# ---------------------------------------------------------------------------

POOLED = ["timelines", "extended axes", "hardware cross timelines"]


@pytest.mark.parametrize("name", POOLED)
def test_pooled_sweep_equals_serial(name):
    build, kw = SWEEPS[name]
    exp = build(PORT, "auto")
    serial = exp.sweep(workers=0, device="cpu", **kw)
    pooled = exp.sweep(workers=2, device="cpu", **kw)
    assert serial.executor == "serial" and pooled.executor == "process[2]"
    pooled.executor = "serial"
    _same_runs(serial, pooled)


def test_persistent_engine_reuses_its_pool_and_memos():
    """A ``with``-entered engine starts one pool for one experiment, and a
    planner lent it keeps it warm across calls."""
    with TA.SweepEngine(workers=2, device="cpu") as eng:
        mesh_a, report_a = T_plan_serving("yi-6b", "tpu_v5e_2x2", batch=4, context_len=128,
                                          engine=eng)
        mesh_b, report_b = T_plan_serving("yi-6b", "tpu_v5e_2x2", batch=4, context_len=128,
                                          engine=eng)
        assert eng.pool_inits == 1
    from repro.serving.planner import plan_serving as R_plan_serving
    mesh_r, report_r = R_plan_serving("yi-6b", "tpu_v5e_2x2", batch=4, context_len=128)
    assert mesh_a == mesh_b == mesh_r and mesh_a["data"] * mesh_a["model"] == 4
    assert report_a.executor == "process[2]"
    report_a.executor = report_r.executor
    assert report_a.to_json() == report_r.to_json() == report_b.to_json().replace(
        "process[2]", report_r.executor)


# ---------------------------------------------------------------------------
# planners (tests/test_api.py's co-design, tests/test_system.py's planner)
# ---------------------------------------------------------------------------

def _codesign_cfg(side, **kw):
    return side.api.PlannerCfg(global_batch=8, seq_len=128, max_plans=3,
                               microbatch_sizes=(1,),
                               hardware_search=side.api.HardwareSearchSpace(
                                   tile_flops=(100e12, 197e12)), **kw)


def test_plan_codesign_picks_known_best_variant():
    ref, port = (side.api.plan_codesign(side.get_config("yi-6b"), side.core.tpu_v5e_pod(2, 2),
                                        _codesign_cfg(side)) for side in SIDES)
    assert port.to_json() == ref.to_json()
    assert _doc(port.report) == _doc(ref.report)
    assert "197T" in port.hardware.name and port.hardware.tile.flops == 197e12
    assert port.run is port.report.best and port.plan == port.report.best.plan
    assert TA.HardwareSpec.from_json(port.hardware.to_json()).to_dict() == \
        port.hardware.to_dict()


PLANNER_CASES = {
    "hardware search": ("yi-6b", lambda s: s.core.tpu_v5e_pod(2, 2),
                        lambda s: _codesign_cfg(s)),
    "yi-6b on 4x4": ("yi-6b", lambda s: s.core.tpu_v5e_pod(4, 4),
                     lambda s: s.api.PlannerCfg(global_batch=64, seq_len=512, max_plans=12,
                                                microbatch_sizes=(1, 2))),
    "granite-moe on 2x4": ("granite-moe-3b-a800m", lambda s: s.core.tpu_v5e_pod(2, 4),
                           lambda s: s.api.PlannerCfg(global_batch=32, seq_len=256,
                                                      max_plans=8, microbatch_sizes=(1,))),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_plan_parallelism_equals_reference(case):
    arch, hw, cfg = PLANNER_CASES[case]
    ref, port = (side.api.plan_parallelism(side.get_config(arch), hw(side), cfg(side))
                 for side in SIDES)
    assert [r.to_json() for r in port] == [r.to_json() for r in ref]
    thpts = [r.throughput for r in port]
    assert port and thpts == sorted(thpts, reverse=True)
    if case == "hardware search":
        assert len({r.hardware for r in port}) == 2
    if case == "yi-6b on 4x4":
        best = port[0].plan
        assert len(port) >= 3 and best.pp * best.dp * best.tp == 16


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

def _raise(exc):
    def raiser(*a, **k):
        raise exc
    return raiser


def _hardware_cross_jobs():
    build, _ = SWEEPS["hardware cross"]      # 16 jobs, 4 signature groups
    exp = build(PORT, "auto")
    specs = exp.hardware_search.enumerate_specs(exp.hardware_spec)
    return build, exp, specs, [(v, p) for v, spec in enumerate(specs)
                               for p in exp._plans_for(spec)]


def _count_reruns(monkeypatch):
    reruns = []
    per_job = T_sweep._run_and_finish
    monkeypatch.setattr(T_sweep, "_run_and_finish",
                        lambda *a, **k: reruns.append(1) or per_job(*a, **k))
    return reruns


# what the batch raises past its host compile: (module, name, value, error, message)
PAST_THE_HOST_COMPILE = {
    "depth in the group compiler": (T_fastbatch, "MAX_DEPTH", 0, ValueError, "deep"),
    "depth in the kernel checks": (T_chain_replay, "MAX_DEPTH", 0, ValueError, "deep"),
    "a KeyError in the device replay": (T_fastbatch, "_replay_group",
                                        _raise(KeyError("mailbox")), KeyError, "mailbox"),
    "a TypeError in the kernel checks": (T_build, "refuse_dtensor",
                                         _raise(TypeError("DTensor")), TypeError, "DTensor"),
}


@pytest.mark.parametrize("where", sorted(PAST_THE_HOST_COMPILE))
def test_batch_errors_past_the_host_compile_are_not_rerun_on_the_host(monkeypatch, where):
    """A refusal of ``chain_replay``, or any error of the group's program
    compile or its device replay, leaves ``evaluate_jobs`` and
    ``Experiment.sweep`` as it was raised; no job runs the per-job host
    path."""
    _, exp, specs, jobs = _hardware_cross_jobs()
    reruns = _count_reruns(monkeypatch)
    module, name, value, error, message = PAST_THE_HOST_COMPILE[where]
    monkeypatch.setattr(module, name, value)
    with pytest.raises(error, match=message):
        TA.SweepEngine(device="cpu").evaluate_jobs(exp, specs, jobs)
    with pytest.raises(error, match=message):
        exp.sweep(device="cpu")
    assert reruns == []


def test_host_compile_error_reruns_the_batch_per_job(monkeypatch):
    """An error of the batch's host compile re-runs every job of the batch
    on the per-job path, as the reference does, with the reference's
    results."""
    build, exp, _, jobs = _hardware_cross_jobs()
    reruns = _count_reruns(monkeypatch)
    monkeypatch.setattr(T_fastbatch, "_signature", _raise(ValueError("host compile")))
    rerun = exp.sweep(device="cpu", profile=True)
    assert len(reruns) == len(jobs) == rerun.profile["fallback_jobs"]
    assert _doc(rerun) == _doc(build(REF, "auto").sweep())


NO_CARD = {
    "SweepEngine()": lambda: TA.SweepEngine(),
    "shared_engine()": lambda: TA.shared_engine(),
    "Experiment.sweep": lambda: _tiny(PORT, search=TA.SearchSpace(max_plans=2)).sweep(),
}


@pytest.mark.parametrize("what", sorted(NO_CARD))
def test_no_device_means_the_card(monkeypatch, what):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        NO_CARD[what]()


HOST_PLANNERS = {
    "plan_parallelism": lambda s: s.api.plan_parallelism(
        s.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2),
        s.api.PlannerCfg(global_batch=8, seq_len=128, max_plans=2)),
    "plan_serving": lambda s: s.planner.plan_serving("yi-6b", "tpu_v5e_2x2", batch=4,
                                                     context_len=128)[1],
}


@pytest.mark.parametrize("what", sorted(HOST_PLANNERS))
def test_planners_are_host_code(monkeypatch, what):
    """The exhaustive planners' experiments run the event engine, which
    never reaches the batched tier: they run without a card, launch nothing
    and give the reference's reports."""
    from repro_torch import kernels
    ref = HOST_PLANNERS[what](REF)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernels.reset_launch_counts()
    port = HOST_PLANNERS[what](PORT)
    assert kernels.launch_counts()["chain_replay"] == 0
    runs = port if isinstance(port, list) else port.runs
    assert runs and all(r.extra.get("engine", "event") == "event" for r in runs)
    assert [r.to_json() for r in runs] == [
        r.to_json() for r in (ref if isinstance(ref, list) else ref.runs)]


def test_cpu_sweep_launches_nothing():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    rep = SWEEPS["plain"][0](PORT, "auto").sweep(device="cpu", profile=True)
    assert rep.profile["jobs"] == rep.num_candidates > 0
    assert kernels.launch_counts()["chain_replay"] == 0
