"""The port's simulator core (``repro_torch.core``) against the reference
(``repro.core``): each case builds its graph, hardware and plan in both
packages from the same arguments and asks for exact equality — the event
tier, the scalar fast tier and its classifier, ``arch_to_graph`` for every
arch of the zoo, the hardware presets, Trace bytes crossing both ways,
``sweep_plans`` — and the paths the port does not have yet refuse."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.fastpath as R_fastpath  # noqa: E402
from repro import configs as R_configs  # noqa: E402
from repro.core.workload import arch_to_graph as R_arch_to_graph  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.core.fastpath as T_fastpath  # noqa: E402
from repro_torch import configs as T_configs  # noqa: E402
from repro_torch.core.workload import arch_to_graph as T_arch_to_graph  # noqa: E402

from torch_core_common import assert_same_result  # noqa: E402

GB = 1e9
PKGS = (R, T)


def _mesh(pkg, n=4, tile_shape=(2, 2), torus=False, ports=True, flops=4e12,
          dram_bw=64 * GB):
    spec = pkg.MeshSpec(rows=n, cols=n, intra_bw=64 * GB, inter_bw=16 * GB,
                        link_latency=2e-8, tile_shape=tile_shape, torus=torus)
    topo = spec.compile()
    return pkg.HardwareSpec(
        name=f"mesh{n}{'t' if torus else ''}", topology=spec,
        tile=pkg.TileSpec(flops=flops, sram_bytes=2e6),
        dram=pkg.DRAMSpec(bandwidth=dram_bw, response_time=3e-7, channels=4),
        dram_ports=(topo.device(0, 0), topo.device(n - 1, 0)) if ports else ())


def _hierarchical(pkg):
    spec = pkg.HierarchicalSpec(
        tile=pkg.MeshSpec(rows=2, cols=2, intra_bw=128 * GB, link_latency=2e-8),
        grid_rows=2, grid_cols=2, inter_bw=32 * GB)
    return pkg.HardwareSpec(name="hier", topology=spec,
                            tile=pkg.TileSpec(flops=8e12, sram_bytes=2e6),
                            dram=pkg.DRAMSpec(bandwidth=64 * GB, response_time=3e-7,
                                              channels=4),
                            dram_ports=(0, 12))


def _gpu(pkg):
    return pkg.HardwareSpec(
        name="gpus", topology=pkg.GPUClusterSpec(num_gpus=8, gpus_per_node=4),
        tile=pkg.TileSpec(flops=100e12, sram_bytes=40e9),
        dram=pkg.DRAMSpec(bandwidth=1500 * GB, response_time=1e-7, channels=8))


HARDWARE = {
    "mesh": _mesh,
    "torus": lambda pkg: _mesh(pkg, torus=True, tile_shape=(4, 4)),
    "hierarchical": _hierarchical,
    "gpu_cluster": _gpu,
    "a100x8": lambda pkg: pkg.a100_cluster(8),
    "grayskull": lambda pkg: pkg.grayskull(),
    "wafer_scale": lambda pkg: pkg.wafer_scale(),
    "tpu_v5e_4x4": lambda pkg: pkg.tpu_v5e_pod(4, 4),
    "tpu_v5e_torus_4x4": lambda pkg: pkg.tpu_v5e_pod(4, 4, torus=True),
}

GRAPHS = {
    "lm": lambda pkg, b: pkg.transformer_lm_graph("t", 4, 256, 4, 128, b, vocab=1024),
    "bert": lambda pkg, b: pkg.bert_base_graph(b, seq_len=64),
    "resnet": lambda pkg, b: pkg.resnet50_graph(b, image=64),
}


def _plan(pkg, pp=2, dp=1, tp=2, mb=1, gb=4, **kw):
    return pkg.ParallelPlan(pp=pp, dp=dp, tp=tp, microbatch=mb, global_batch=gb * dp, **kw)


# (hardware, graph, plan kwargs, NoC mode, boundary mode, timeline)
EVENT_CASES = [
    ("mesh", "lm", dict(), "analytical", "pairwise", True),
    ("mesh", "lm", dict(), "macro", "pairwise", False),
    ("mesh", "lm", dict(), "detailed", "pairwise", True),
    ("mesh", "lm", dict(schedule="gpipe"), "macro", "pairwise", True),
    ("mesh", "lm", dict(schedule="gpipe", recompute="always"), "detailed", "pairwise", False),
    ("mesh", "lm", dict(recompute="always"), "analytical", "strategy", True),
    ("mesh", "lm", dict(dp=2, tp=1, recompute="never"), "macro", "strategy", False),
    ("mesh", "lm", dict(training=False, mb=2, gb=8), "macro", "pairwise", True),
    ("mesh", "lm", dict(training=False, pp=4, tp=1), "detailed", "strategy", False),
    ("torus", "lm", dict(), "detailed", "pairwise", True),
    ("torus", "bert", dict(pp=2, dp=2, tp=1), "macro", "pairwise", False),
    ("hierarchical", "lm", dict(pp=2, dp=2, tp=2), "detailed", "pairwise", True),
    ("gpu_cluster", "lm", dict(pp=2, dp=2, tp=2), "macro", "pairwise", True),
    ("gpu_cluster", "bert", dict(schedule="gpipe", training=False), "analytical",
     "pairwise", False),
    ("a100x8", "lm", dict(pp=2, dp=1, tp=4), "macro", "pairwise", True),
    ("grayskull", "resnet", dict(pp=2, dp=1, tp=1), "macro", "pairwise", True),
    ("wafer_scale", "lm", dict(pp=4, dp=2, tp=2), "detailed", "pairwise", True),
    ("wafer_scale", "bert", dict(recompute="always"), "macro", "strategy", False),
    ("tpu_v5e_4x4", "lm", dict(pp=1, dp=2, tp=4), "analytical", "pairwise", True),
    ("tpu_v5e_torus_4x4", "resnet", dict(pp=2, dp=2, tp=1, training=False), "detailed",
     "pairwise", True),
]


def _sim(pkg, case, engine="event"):
    hw_name, graph_name, kw, mode, boundary, timeline = case
    plan = _plan(pkg, **kw)
    graph = GRAPHS[graph_name](pkg, plan.microbatch * plan.dp)
    return pkg.PipelineSimulator(pkg.map_graph(graph, HARDWARE[hw_name](pkg), plan),
                                 noc_mode=pkg.NoCMode(mode), collect_timeline=timeline,
                                 boundary_mode=pkg.BoundaryMode(boundary), engine=engine)


@pytest.mark.parametrize("case", EVENT_CASES, ids=lambda c: "-".join(
    [c[0], c[1], c[3], c[4], "tl" if c[5] else "no_tl"] + [f"{k}={v}" for k, v in c[2].items()]))
def test_event_tier_equals_reference(case):
    a, b = (_sim(pkg, case).run() for pkg in PKGS)
    assert a.engine == "event"
    assert_same_result(a, b, case)


@pytest.mark.parametrize("case", EVENT_CASES[:10], ids=lambda c: f"{c[0]}-{c[3]}-{c[4]}")
def test_fast_tier_and_classifier_equal_reference(case):
    """``engine="auto"`` gives the reference's result and tier, and the
    classifier the same reason string."""
    ra, rb = (_sim(pkg, case, "auto") for pkg in PKGS)
    assert R_fastpath.classify(ra) == T_fastpath.classify(rb)
    a, b = ra.run(), rb.run()
    assert_same_result(a, b, case)
    assert ra.fastpath_reason == rb.fastpath_reason


def test_simulate_entry_point_both_engines():
    case = EVENT_CASES[2]
    for engine in ("event", "fast", "auto"):
        a, b = (pkg.simulate(GRAPHS["lm"](pkg, 1), HARDWARE["mesh"](pkg), _plan(pkg),
                             noc_mode="detailed", collect_timeline=True, engine=engine)
                for pkg in PKGS)
        assert_same_result(a, b, (case, engine))


def test_strict_fast_engine_raises_as_reference():
    """An interleaved plan is classifier-ineligible: ``engine="fast"`` raises
    FastPathIneligible with the reference's reason in both packages."""
    msgs = []
    for pkg, fp in ((R, R_fastpath), (T, T_fastpath)):
        plan = _plan(pkg, pp=2, tp=1, gb=8, interleave=2)
        sim = pkg.PipelineSimulator(
            pkg.map_graph(GRAPHS["lm"](pkg, 1), HARDWARE["mesh"](pkg), plan), engine="fast")
        with pytest.raises(fp.FastPathIneligible) as err:
            sim.run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "interleaved" in msgs[0]


@pytest.mark.parametrize("name", sorted(R_configs.ARCHS))
def test_arch_to_graph_equals_reference(name):
    """Every zoo arch at full width, training, prefill and decode: the same
    ops, field by field and in their cost accounting."""
    for kw in (dict(training=True), dict(training=False), dict(training=False, decode=True)):
        try:
            a = R_arch_to_graph(R_configs.get_config(name), 256, 2, **kw)
        except Exception as e:          # the port must refuse alike
            with pytest.raises(type(e)):
                T_arch_to_graph(T_configs.get_config(name), 256, 2, **kw)
            continue
        b = T_arch_to_graph(T_configs.get_config(name), 256, 2, **kw)
        assert (a.name, a.edges, len(a.ops)) == (b.name, b.edges, len(b.ops))
        for x, y in zip(a.ops, b.ops):
            assert type(x).__name__ == type(y).__name__
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
            for f in ("fwd_flops", "bwd_flops", "param_count", "in_elems", "out_elems"):
                assert getattr(x, f)() == getattr(y, f)(), (name, kw, x.name, f)
            assert x.matmul_fraction == y.matmul_fraction


PRESETS = [n for n in R.HARDWARE_PRESETS if n != "tiled_cluster"]


@pytest.mark.parametrize("name", PRESETS + ["a100x8", "hierarchical", "gpu_cluster"])
def test_hardware_dict_equals_reference_both_ways(name):
    make_r = R.HARDWARE_PRESETS.get(name) or (lambda: HARDWARE[name](R))
    make_t = T.HARDWARE_PRESETS.get(name) or (lambda: HARDWARE[name](T))
    a, b = make_r(), make_t()
    assert a.to_dict() == b.to_dict()
    assert T.HardwareSpec.from_dict(a.to_dict()).to_dict() == a.to_dict()
    assert R.HardwareSpec.from_json(b.to_json()).to_dict() == b.to_dict()


def test_trace_bytes_cross_both_ways():
    case = EVENT_CASES[0]
    a, b = (_sim(pkg, case).run() for pkg in PKGS)
    back_r = R.Trace.from_bytes(b.trace.to_bytes())
    back_t = T.Trace.from_bytes(a.trace.to_bytes())
    assert back_r == a.trace and back_t == b.trace
    assert back_r.to_bytes() == back_t.to_bytes() == a.trace.to_bytes()
    assert a.trace.summary() == b.trace.summary()


def _ranking(pkg, memory_cap=None):
    hw = HARDWARE["mesh"](pkg)
    plans = [_plan(pkg, pp=pp, dp=dp, tp=tp, mb=mb, gb=4)
             for pp, dp, tp, mb in ((1, 1, 1, 1), (2, 1, 1, 1), (2, 1, 2, 1), (4, 1, 1, 1),
                                    (2, 2, 1, 1), (1, 2, 2, 2), (4, 1, 2, 2))]
    out = pkg.sweep_plans(lambda p: GRAPHS["lm"](pkg, p.microbatch * p.dp), hw, plans,
                          noc_mode="macro", memory_cap=memory_cap, engine="auto")
    return [(r.plan.pp, r.plan.dp, r.plan.tp, r.plan.microbatch, r.throughput,
             r.result.total_time) for r in out]


def test_sweep_plans_ranking_equals_reference():
    full = _ranking(R)
    assert _ranking(T) == full and len(full) == 7
    # a cap between the plans' footprints drops some of them
    hw = HARDWARE["mesh"](R)
    peaks = sorted(max(m.total for m in R.PipelineSimulator(R.map_graph(
        GRAPHS["lm"](R, 1), hw, _plan(R, pp=pp, tp=tp))).memory)
        for pp, tp in ((1, 1), (4, 1)))
    cap = (peaks[0] + peaks[1]) / 2
    capped = _ranking(R, cap)
    assert 0 < len(capped) < len(full)
    assert _ranking(T, cap) == capped


def test_unported_paths_refuse():
    """The fabric and obs paths wait for their slices and say so."""
    with pytest.raises(NotImplementedError, match="fabric"):
        T.HardwareSpec.from_dict(R.HARDWARE_PRESETS["tiled_cluster"]().to_dict())
    with pytest.raises(NotImplementedError, match="fabric"):
        T.HARDWARE_PRESETS["tiled_cluster"]()
    from repro_torch.core.hardware import tiled_cluster
    with pytest.raises(NotImplementedError, match="fabric"):
        tiled_cluster()
    plan = _plan(T)
    graph = GRAPHS["lm"](T, 1)
    with_fabric = dataclasses.replace(HARDWARE["mesh"](T), fabric=object())
    with pytest.raises(NotImplementedError, match="fabric"):
        T.PipelineSimulator(T.map_graph(graph, with_fabric, plan))
    sim = T.PipelineSimulator(T.map_graph(graph, HARDWARE["mesh"](T), plan), metrics=True)
    with pytest.raises(NotImplementedError, match="obs"):
        sim.run()


def test_exports_equal_reference():
    def names(pkg):
        return sorted(n for n, v in vars(pkg).items()
                      if not n.startswith("_") and not isinstance(v, type(pkg)))
    assert names(R) == names(T)
