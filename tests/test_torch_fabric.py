"""The port's scale-out fabric (``repro_torch.fabric``) against the
reference (``repro.fabric``): each case builds its specs, hardware and
plans in both packages from the same arguments and asks for exact
equality — spec validation, JSON and routing, the collective schedules
and their alpha-beta bounds, collective times on the event core in every
NoC mode, ``simulate`` on ``tiled_cluster`` (every SimResult field and
the raw trace, FABRIC lanes, the Chrome export), the degenerate one-chip
fabric, and the fast tier's results and reasons on the fabric machine.
Through ``repro_torch.api`` and ``repro_torch.search``: the fabric's
search axes, co-design over a fabric axis (exhaustive and guided),
pooled fabric sweeps and the serving rungs' request truncation, as the
reference's ``tests/test_fabric.py`` holds them."""

import dataclasses
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import repro.api as RA  # noqa: E402
import repro.core as R  # noqa: E402
import repro.core.fastpath as R_fastpath  # noqa: E402
import repro.fabric as RF  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro.core.hardware import tiled_cluster as R_tiled_cluster  # noqa: E402
from repro.core.workload import arch_to_graph as R_arch_to_graph  # noqa: E402
from repro.fabric.model import FabricModel as R_FabricModel  # noqa: E402
from repro.obs.tracks import activity_counters as R_activity_counters  # noqa: E402

import repro_torch.api as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.fastpath as T_fastpath  # noqa: E402
import repro_torch.fabric as TF  # noqa: E402
from repro_torch.configs import get_config as T_get_config  # noqa: E402
from repro_torch.core.hardware import tiled_cluster as T_tiled_cluster  # noqa: E402
from repro_torch.core.topology import spec_of as T_spec_of  # noqa: E402
from repro_torch.core.trace import KIND_FABRIC  # noqa: E402
from repro_torch.core.workload import arch_to_graph as T_arch_to_graph  # noqa: E402
from repro_torch.fabric.model import FabricModel as T_FabricModel  # noqa: E402
from repro_torch.obs.tracks import activity_counters as T_activity_counters  # noqa: E402

from torch_core_common import assert_same_result  # noqa: E402

GB = 1e9
# (core, fabric, tiled_cluster, FabricModel, fastpath, activity_counters)
REF = (R, RF, R_tiled_cluster, R_FabricModel, R_fastpath, R_activity_counters)
PORT = (T, TF, T_tiled_cluster, T_FabricModel, T_fastpath, T_activity_counters)
SIDES = (REF, PORT)


def _both(fn):
    """``fn(side)`` for the reference and the port."""
    return [fn(side) for side in SIDES]


# ---------------------------------------------------------------------------
# spec: validation, shape/routing arithmetic, serialization
# ---------------------------------------------------------------------------

BAD_SPECS = {
    "degree": lambda F: F.FabricLevel("board", degree=0, bandwidth=1 * GB),
    "bandwidth": lambda F: F.FabricLevel("board", degree=2, bandwidth=0),
    "latency": lambda F: F.FabricLevel("board", degree=2, bandwidth=1 * GB, latency=-1e-6),
    "algorithm": lambda F: F.FabricLevel("board", degree=2, bandwidth=1 * GB,
                                         algorithm="magic"),
    "at least one level": lambda F: F.FabricSpec(levels=()),
    "collective": lambda F: F.FabricSpec(levels=(F.FabricLevel("b", 2, 1 * GB),),
                                         collective="nope"),
}


@pytest.mark.parametrize("what", sorted(BAD_SPECS))
def test_spec_validation_equals_reference(what):
    msgs = []
    for F in (RF, TF):
        with pytest.raises(ValueError, match=what) as err:
            BAD_SPECS[what](F)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("preset", sorted(RF.FABRIC_PRESETS))
def test_preset_json_round_trip_across_packages(preset):
    assert sorted(TF.FABRIC_PRESETS) == sorted(RF.FABRIC_PRESETS)
    ref, port = RF.FABRIC_PRESETS[preset](), TF.FABRIC_PRESETS[preset]()
    assert port.to_json() == ref.to_json()
    assert json.loads(port.to_json())["name"] == preset
    back = TF.FabricSpec.from_json(port.to_json())
    assert back == port and TF.FabricSpec.from_json(back.to_json()) == back
    assert TF.FabricSpec.from_json(ref.to_json()).to_dict() == ref.to_dict()
    assert RF.FabricSpec.from_json(port.to_json()) == ref
    assert TF.fabric_spec_from_dict(ref.to_dict()) == port
    assert (TF.COLLECTIVE_FAMILIES, TF.LEVEL_ALGORITHMS) == \
        (RF.COLLECTIVE_FAMILIES, RF.LEVEL_ALGORITHMS)


def _shape(fab):
    """Every derived quantity of a spec: per level, per chip, per link and
    per chip pair."""
    L, C = fab.num_levels, fab.num_chips
    return {
        "scalars": (fab.num_levels, fab.degrees, fab.num_chips, fab.num_links()),
        "levels": [(fab.chips_per_child(l), fab.chips_per_group(l), fab.instances(l),
                    fab.link_offset(l)) for l in range(L)],
        "ports": [[(fab.up_link(l, c), fab.down_link(l, c)) for c in range(C)]
                  for l in range(L)],
        "links": [(fab.link_level(i), fab.link_bandwidth(i), fab.link_latency(i))
                  for i in range(fab.num_links())],
        "pairs": {(a, b): (fab.ancestor_level(a, b) if a != b else None, fab.route(a, b))
                  for a in range(C) for b in range(C)},
    }


@pytest.mark.parametrize("preset", sorted(RF.FABRIC_PRESETS))
def test_routes_and_link_ids_equal_reference(preset):
    ref, port = RF.FABRIC_PRESETS[preset](), TF.FABRIC_PRESETS[preset]()
    assert _shape(port) == _shape(ref)
    with pytest.raises(ValueError, match="out of range"):
        port.link_level(port.num_links())


def test_cluster_2x2_shape_and_routing():
    """The reference's own checks of cluster_2x2, on the port."""
    fab = TF.cluster_2x2()
    assert fab.num_chips == 4 and fab.degrees == (2, 2)
    assert fab.num_links() == 12
    assert fab.chips_per_child(0) == 1 and fab.chips_per_child(1) == 2
    assert fab.chips_per_group(0) == 2 and fab.chips_per_group(1) == 4
    assert fab.route(0, 1) == [fab.up_link(0, 0), fab.down_link(0, 1)]
    assert fab.route(0, 3) == [fab.up_link(0, 0), fab.up_link(1, 0),
                               fab.down_link(1, 3), fab.down_link(0, 3)]
    assert fab.route(2, 2) == []
    assert {fab.link_level(l) for l in range(8)} == {0}
    assert {fab.link_level(l) for l in range(8, 12)} == {1}
    assert fab.link_bandwidth(0) == 100 * GB and fab.link_bandwidth(8) == 25 * GB


def test_with_level_derivation():
    derived = _both(lambda s: s[1].cluster_2x2().with_level(1, bandwidth=50 * GB)
                    .with_level(0, latency=1e-6).to_dict())
    assert derived[0] == derived[1]
    fab = TF.cluster_2x2()
    d = fab.with_level(1, bandwidth=50 * GB)
    assert d.levels[1].bandwidth == 50 * GB and d.levels[0] == fab.levels[0]
    assert fab.levels[1].bandwidth == 25 * GB      # original untouched


def test_tiled_cluster_hardware_equals_reference_both_ways():
    ref, port = R_tiled_cluster(), T_tiled_cluster()
    assert port.to_dict() == ref.to_dict()
    assert T.HARDWARE_PRESETS["tiled_cluster"]().to_dict() == ref.to_dict()
    assert port.fabric is not None and port.num_chips == 4
    assert port.num_devices == 4 * port.chip_devices == ref.num_devices
    back = T.HardwareSpec.from_json(ref.to_json())
    assert back.to_dict() == ref.to_dict() and back.fabric == port.fabric
    assert R.HardwareSpec.from_json(port.to_json()).fabric == ref.fabric
    ws = T.wafer_scale()
    assert ws.fabric is None and ws.num_chips == 1 and "fabric" not in ws.to_dict()


def test_hierarchical_spec_round_trips_through_hardware_json():
    ws = T.wafer_scale()
    assert isinstance(T_spec_of(ws.topology), T.HierarchicalSpec)
    once = T.HardwareSpec.from_json(ws.to_json())
    assert T_spec_of(once.topology) == T_spec_of(ws.topology)
    twice = T.HardwareSpec.from_json(once.to_json())
    assert T_spec_of(twice.topology) == T_spec_of(ws.topology)
    assert twice.to_dict() == R.HardwareSpec.from_json(ws.to_json()).to_dict()


# ---------------------------------------------------------------------------
# collective schedules and their bounds
# ---------------------------------------------------------------------------

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all", "broadcast", "reduce")


@pytest.mark.parametrize("algorithm", ["ring", "tree", "hd"])
@pytest.mark.parametrize("kind", KINDS)
def test_rounds_equal_reference(algorithm, kind):
    for p in range(2, 9):
        for members in (list(range(p)), [3 * m + 1 for m in range(p)]):
            for root in (None, members[-1]):
                a = RF.rounds_for(algorithm, kind, members, 1e6 / 3, root=root)
                b = TF.rounds_for(algorithm, kind, members, 1e6 / 3, root=root)
                assert b == a, (algorithm, kind, members, root)
    for fn in ("ring_rounds", "hd_rounds"):
        if kind not in ("broadcast", "reduce", "all_to_all"):
            assert getattr(TF, fn)(list(range(6)), kind, 7e5) == \
                getattr(RF, fn)(list(range(6)), kind, 7e5)
    assert TF.pairwise_rounds(list(range(5)), 3e5) == RF.pairwise_rounds(list(range(5)), 3e5)
    with pytest.raises(ValueError):
        TF.rounds_for("warp", "all_reduce", [0, 1], 1.0)


def test_alpha_beta_lower_bound_equals_reference():
    for kind, p, n, bw in itertools.product(KINDS, range(1, 9), (0.0, 1e3, 7e6 / 3),
                                            (12.5 * GB, 100 * GB)):
        assert TF.alpha_beta_lower_bound(kind, p, n, bw) == \
            RF.alpha_beta_lower_bound(kind, p, n, bw)
    with pytest.raises(ValueError):
        TF.alpha_beta_lower_bound("gather", 4, 1.0, 1.0)


# ---------------------------------------------------------------------------
# collective costs on the event core
# ---------------------------------------------------------------------------

def _one_device_chips(side, fabric):
    """One device per chip with an effectively free NoC: the simulated
    collective time is the fabric schedule's own."""
    core = side[0]
    return core.HardwareSpec(
        name=f"fab_{fabric.name}", topology=core.MeshSpec(1, 1, intra_bw=1e12),
        tile=core.TileSpec(flops=1e12, sram_bytes=1e6), dram=core.DRAMSpec(bandwidth=1e12),
        fabric=fabric)


def _collective(side, fabric, kind, nbytes, mode="detailed"):
    core, model = side[0], side[3]
    env = core.Environment()
    fm = model(env, _one_device_chips(side, fabric), mode=core.NoCMode(mode))
    proc = env.process(fm.collective(kind, list(range(fabric.num_chips)), nbytes))
    env.run(until_event=proc)
    return env.now, fm.fabric_bytes, fm.fabric_transfers


def _fabric(side, preset, family=None):
    fab = side[1].FABRIC_PRESETS[preset]()
    return dataclasses.replace(fab, collective=family) if family else fab


@pytest.mark.parametrize("mode", ["analytical", "macro", "detailed"])
@pytest.mark.parametrize("family", ["ring", "tree", "hd", "hierarchical"])
@pytest.mark.parametrize("preset", ["cluster_2x2", "rack_2x2x2"])
def test_collective_times_equal_reference(preset, family, mode):
    """Every bulk kind at two payloads: the same finish time and counters,
    and the reference's per-level alpha-beta bound holds."""
    for kind in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        for kb in (64, 1024):
            got = _both(lambda s: _collective(s, _fabric(s, preset, family), kind, kb * 1e3,
                                              mode))
            assert got[1] == got[0], (kind, kb)
            fab = TF.FABRIC_PRESETS[preset]()
            if mode == "detailed" and kind != "all_to_all":
                bound = sum(TF.alpha_beta_lower_bound(kind, lvl.degree,
                                                      kb * 1e3 / fab.chips_per_child(i),
                                                      lvl.bandwidth)
                            for i, lvl in enumerate(fab.levels))
                assert got[1][0] >= bound * (1 - 1e-9), (kind, kb)


def test_single_level_ring_allreduce_matches_closed_form():
    p, bw, lat, nbytes = 4, 10 * GB, 1e-6, 4e6
    times = {}
    for mode in ("detailed", "macro"):
        got = _both(lambda s: _collective(
            s, s[1].FabricSpec(name="flat", collective="ring",
                               levels=(s[1].FabricLevel("board", p, bw, latency=lat),)),
            "all_reduce", nbytes, mode)[0])
        assert got[0] == got[1]
        times[mode] = got[1]
    assert times["detailed"] == pytest.approx(2 * (p - 1) * (nbytes / p / bw + 2 * lat),
                                              rel=1e-9)
    assert times["macro"] == pytest.approx(times["detailed"], rel=1e-9)


def test_hierarchical_beats_flat_ring_at_scale():
    t = {fam: _collective(PORT, _fabric(PORT, "rack_2x2x2", fam), "all_reduce", 64e3)[0]
         for fam in ("hierarchical", "ring")}
    assert t["hierarchical"] <= t["ring"]


def test_fabric_counters_and_modes():
    t_det, moved, count = _collective(PORT, TF.cluster_2x2(), "all_reduce", 1e6)
    assert moved > 0 and count > 0
    t_ana = _collective(PORT, TF.cluster_2x2(), "all_reduce", 1e6, "analytical")[0]
    assert 0 < t_ana <= t_det * (1 + 1e-9)
    p, top = 4, TF.cluster_2x2().levels[-1]
    t_a2a = _collective(PORT, TF.cluster_2x2(), "all_to_all", 1e6)[0]
    assert t_a2a >= (p // 2) ** 2 * (1e6 / p) / (top.bandwidth * 2) * (1 - 1e-9)


# ---------------------------------------------------------------------------
# simulate on tiled_cluster
# ---------------------------------------------------------------------------

PLANS = ((1, 2, 2), (2, 1, 2), (2, 2, 2))


def _cluster_plan(core, plan, schedule="1f1b", training=True):
    pp, dp, tp = plan
    return core.ParallelPlan(pp=pp, dp=dp, tp=tp, microbatch=1, global_batch=4 * dp,
                             schedule=core.Schedule(schedule), training=training)


def _cluster_graph(core, plan):
    return core.transformer_lm_graph("t", 2, 256, 8, 128, plan[1], vocab=2048)


@pytest.mark.parametrize("timeline", [True, False], ids=["timeline", "no_timeline"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("mode", ["analytical", "macro", "detailed"])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "pp{}dp{}tp{}".format(*p))
def test_tiled_cluster_simulation_equals_reference(plan, mode, schedule, training, timeline):
    """``simulate`` on the event tier: every SimResult field and the raw
    trace; with timelines, the fabric's lanes as the reference has them."""
    a, b = (side[0].simulate(_cluster_graph(side[0], plan), side[2](),
                             _cluster_plan(side[0], plan, schedule, training),
                             noc_mode=mode, collect_timeline=timeline) for side in SIDES)
    assert_same_result(a, b, (plan, mode, schedule, training, timeline))
    assert b.trace.summary() == a.trace.summary()
    lanes = {int(r) for k, r in zip(b.trace.kind, b.trace.resource) if int(k) == KIND_FABRIC}
    if timeline and mode != "analytical" and plan[0] * plan[1] > 2:
        assert lanes, "a chip-spanning plan left no fabric intervals"
        assert b.trace.summary()["fabric_occupancy"]
    if not timeline:
        assert not lanes


def test_cluster_sim_emits_fabric_lanes_and_chrome_export():
    """The reference's acceptance case at the port's entry point: full-width
    yi-6b at sequence 128 over all 64 tiles of the 4-chip cluster, the dp
    gradient all-reduce spanning chips; fabric lanes in the trace, its
    occupancy and the Chrome export (with the activity counter tracks)
    equal to the reference's byte for byte."""
    runs = []
    for side, arch_to_graph, get_config in ((REF, R_arch_to_graph, R_get_config),
                                            (PORT, T_arch_to_graph, T_get_config)):
        core = side[0]
        plan = core.ParallelPlan(pp=2, dp=8, tp=4, microbatch=1, global_batch=8)
        graph = arch_to_graph(get_config("yi-6b"), 128, plan.microbatch * plan.dp,
                              training=True)
        res = core.simulate(graph, side[2](), plan, collect_timeline=True)
        chrome = core.chrome_trace(res.trace, counters=side[5](res.trace))
        runs.append((res, json.dumps(chrome, sort_keys=True)))
    (a, chrome_a), (b, chrome_b) = runs
    assert_same_result(a, b)
    assert chrome_b == chrome_a
    assert {int(r) for k, r in zip(b.trace.kind, b.trace.resource) if int(k) == KIND_FABRIC}
    occ = b.trace.resource_occupancy(KIND_FABRIC)
    assert occ and all(v > 0 for v in occ.values())
    chrome = json.loads(chrome_b)
    names = [e["args"]["name"] for e in chrome["traceEvents"] if e.get("name") == "process_name"]
    assert any(n.endswith("fabric links") for n in names)
    threads = [e["args"]["name"] for e in chrome["traceEvents"] if e.get("name") == "thread_name"]
    assert any(t.startswith("flink") for t in threads)


@pytest.mark.parametrize("mode", ["analytical", "macro", "detailed"])
def test_degenerate_fabric_is_transparent(mode):
    """A one-chip, degree-1 fabric is a no-op: the plain mesh's result, bit
    for bit, in both packages."""
    out = []
    for side in SIDES:
        core, F = side[0], side[1]
        solo = F.FabricSpec(name="solo", levels=(F.FabricLevel("board", 1, 1 * GB),))
        plan = core.ParallelPlan(pp=2, dp=1, tp=2, microbatch=1, global_batch=4)
        graph = core.transformer_lm_graph("t", 2, 256, 8, 128, 1, vocab=2048)
        runs = [core.simulate(graph, core.HardwareSpec(
            name="chip2x2", topology=core.MeshSpec(2, 2, intra_bw=512 * GB),
            tile=core.TileSpec(flops=16e12, sram_bytes=4e6),
            dram=core.DRAMSpec(bandwidth=1e11, channels=2), fabric=fabric), plan,
            noc_mode=mode, collect_timeline=True) for fabric in (None, solo)]
        # the facade's processes add events; the result and trace do not move
        assert runs[1].total_time == runs[0].total_time
        assert runs[1].trace == runs[0].trace
        assert not any(int(k) == KIND_FABRIC for k in runs[1].trace.kind)
        out.append(runs[1])
    assert_same_result(out[0], out[1], mode)


# ---------------------------------------------------------------------------
# the fast tiers on the fabric machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["analytical", "macro", "detailed"])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "pp{}dp{}tp{}".format(*p))
def test_fabric_tiers_equal_reference(plan, mode):
    """``engine="auto"`` gives the reference's result, tier and reason;
    ``engine="fast"`` the same result, or raises the same reason."""
    def sim(side, engine):
        core = side[0]
        return core.PipelineSimulator(
            core.map_graph(_cluster_graph(core, plan), side[2](), _cluster_plan(core, plan)),
            noc_mode=core.NoCMode(mode), collect_timeline=True, engine=engine)
    ra, rb = (sim(s, "auto") for s in SIDES)
    assert T_fastpath.classify(rb) == R_fastpath.classify(ra)
    a, b = ra.run(), rb.run()
    assert_same_result(a, b, (plan, mode))
    assert rb.fastpath_reason == ra.fastpath_reason
    out = []
    for side in SIDES:
        try:
            out.append(sim(side, "fast").run())
        except side[4].FastPathIneligible as e:
            out.append(str(e))
    if isinstance(out[0], str):
        assert out[1] == out[0]
    else:
        assert_same_result(out[0], out[1], (plan, mode, "fast"))
    if mode == "analytical":
        assert b.engine == "fast"


# ---------------------------------------------------------------------------
# the fabric through the Experiment API: pooled sweeps and co-design axes
# ---------------------------------------------------------------------------

def _api(side):
    return RA if side is REF else TA


def _fabric_experiment(side, engine):
    api = _api(side)
    return api.Experiment(arch="yi-6b", hardware=side[2](), seq_len=128, global_batch=8,
                          collect_timeline=True, engine=engine,
                          search=api.SearchSpace(degrees=((2, 8, 4), (4, 4, 4)),
                                                 microbatch_sizes=(1,),
                                                 layouts=(api.Layout.S_SHAPE,)))


@pytest.mark.parametrize("engine", ["event", "auto"])
def test_serial_and_pool_fabric_sweeps_ship_identical_traces(engine):
    """A fabric-spanning sweep is bit-identical between the port's serial
    executor, its spawned pool and the reference's serial sweep."""
    ref = _fabric_experiment(REF, engine).sweep(workers=0, return_timelines=True)
    exp = _fabric_experiment(PORT, engine)
    serial = exp.sweep(workers=0, return_timelines=True, device="cpu")
    pooled = exp.sweep(workers=2, return_timelines=True, device="cpu")
    assert pooled.executor == "process[2]" and len(serial.runs) == len(pooled.runs) == 2
    assert serial.to_json() == ref.to_json()
    assert serial.to_json() == pooled.to_json().replace("process[2]", "serial")
    for a, b, r in zip(serial.runs, pooled.runs, ref.runs):
        assert a.plan == b.plan and a.total_time == b.total_time
        assert a.trace == b.trace
        assert a.trace.to_bytes() == r.trace.to_bytes()


FABRIC_AXIS_ERRORS = {
    "collective": lambda api, side: api.HardwareSearchSpace(fabric_collectives=("warp",)),
    "fabric": lambda api, side: api.HardwareSearchSpace(
        fabric_bw=(12.5 * GB, 25 * GB)).enumerate_specs(side[0].wafer_scale()),
}


@pytest.mark.parametrize("what", sorted(FABRIC_AXIS_ERRORS))
def test_fabric_axes_validate_and_require_a_fabric(what):
    msgs = []
    for side in SIDES:
        with pytest.raises(ValueError, match=what) as err:
            FABRIC_AXIS_ERRORS[what](_api(side), side)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_fabric_axes_enumerate_derived_specs():
    ref, port = _both(lambda side: _api(side).HardwareSearchSpace(
        fabric_bw=(12.5 * GB, 25 * GB),
        fabric_collectives=("hierarchical", "ring")).enumerate_specs(side[2]()))
    assert [v.to_json() for v in port] == [v.to_json() for v in ref]
    assert len(port) == 4 and len({v.name for v in port}) == 4
    top = T_tiled_cluster().fabric.num_levels - 1
    assert {v.fabric.levels[top].bandwidth for v in port} == {12.5 * GB, 25 * GB}
    assert {v.fabric.collective for v in port} == {"hierarchical", "ring"}
    for v in port:
        assert TA.HardwareSpec.from_json(v.to_json()).fabric == v.fabric


@pytest.mark.parametrize("strategy", ["exhaustive", "sh"])
def test_plan_codesign_over_fabric_axis_round_trips(strategy):
    """The co-design over a fabric axis, exhaustive and guided (successive
    halving, its rungs on the CPU), equals the reference's, and its
    winner's FabricSpec survives the JSON round trip."""
    guided = {} if strategy == "exhaustive" else dict(
        search_strategy="sh", search_budget=2, search_seed=0)

    def codesign(side):
        api = _api(side)
        cfg = api.PlannerCfg(
            global_batch=8, seq_len=128, max_plans=2, microbatch_sizes=(1,),
            layouts=(api.Layout.S_SHAPE,),
            hardware_search=api.HardwareSearchSpace(fabric_bw=(12.5 * GB, 25 * GB)), **guided)
        get_config = R_get_config if side is REF else T_get_config
        device = {"device": "cpu"} if guided and side is PORT else {}
        return api.plan_codesign(get_config("yi-6b"), side[2](), cfg, **device)
    ref, port = _both(codesign)
    assert port.to_json() == ref.to_json()
    assert port.report.to_json() == ref.report.to_json()
    assert (port.report.search is None) == (strategy == "exhaustive")
    winner = port.hardware
    top = winner.fabric.num_levels - 1
    assert winner.fabric.levels[top].bandwidth in (12.5 * GB, 25 * GB)
    assert TA.HardwareSpec.from_json(winner.to_json()).fabric == winner.fabric


# ---------------------------------------------------------------------------
# serving-rung fidelity truncation (slo objective x guided search)
# ---------------------------------------------------------------------------

def test_fidelity_truncates_serving_workloads():
    """``Fidelity.apply_serving`` cuts a workload to ``max_requests`` as the
    reference's does: the generated count, a replay's request list, and
    nothing when already short or at full fidelity."""
    from repro.search import FULL as R_FULL, Fidelity as R_Fidelity
    from repro.serving.system import ServingSpec as R_ServingSpec
    from repro.serving.workload import WorkloadSpec as R_WorkloadSpec
    from repro_torch.search import FULL, Fidelity
    from repro_torch.serving.system import ServingSpec
    from repro_torch.serving.workload import WorkloadSpec
    rows = [[0.1 * i, 8, 4] for i in range(6)]
    cuts = []
    for fid_cls, full, spec_cls, wl_cls in ((R_Fidelity, R_FULL, R_ServingSpec, R_WorkloadSpec),
                                            (Fidelity, FULL, ServingSpec, WorkloadSpec)):
        fid = fid_cls(name="rung", max_requests=4)
        assert not fid.is_full
        spec = spec_cls(workload=wl_cls(num_requests=64))
        cut = fid.apply_serving(spec)
        assert cut.workload.num_requests == 4
        assert spec.workload.num_requests == 64       # original untouched
        # replay workloads slice the explicit request list too
        replay = spec_cls(workload=wl_cls(kind="replay", requests=rows, num_requests=6))
        cut_replay = fid.apply_serving(replay)
        assert cut_replay.workload.requests == rows[:4]
        assert cut_replay.workload.num_requests == 4
        # already small enough / full fidelity: pass through unchanged
        small = spec_cls(workload=wl_cls(num_requests=3))
        assert fid.apply_serving(small) is small
        assert full.apply_serving(spec) is spec
        assert fid.apply_serving(None) is None
        with pytest.raises(ValueError, match="max_requests") as err:
            fid_cls(name="bad", max_requests=0)
        cuts.append((dataclasses.asdict(cut), dataclasses.asdict(cut_replay), str(err.value)))
    assert cuts[1] == cuts[0]
