"""The port's guided multi-fidelity search (``repro_torch.search``) against
the reference's (``repro.search``), mirroring ``tests/test_search.py``
case by case: each case builds the same experiment in both packages,
runs the same seeded strategy, and asks for exact equality (reports as
JSON, candidates and mutants draw for draw, errors by type and message),
then keeps the reference test's own assertions on the port's result. The
port's batched tier replays on the CPU here (``device="cpu"``); the
fixed-seed pool cases share one spawned pool. Then the port's rule for
``device`` on the planners: guided search only, ``None`` is the card."""

import dataclasses
import random
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import repro.api as RA  # noqa: E402
import repro.core as RC  # noqa: E402
import repro.search as RS  # noqa: E402
from repro.api.report import plan_to_dict as R_plan_to_dict  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402

import repro_torch.api as TA  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro_torch.api.report import plan_to_dict as T_plan_to_dict  # noqa: E402
from repro_torch.configs import get_config as T_get_config  # noqa: E402

REF = SimpleNamespace(api=RA, core=RC, search=RS, get_config=R_get_config, dev={})
PORT = SimpleNamespace(api=TA, core=TC, search=TS, get_config=T_get_config,
                       dev={"device": "cpu"})
SIDES = (REF, PORT)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exp(side, **kw):
    """``tests/test_search.py``'s experiment: yi-6b at sequence 128 on the
    2x2 TPU v5e slice, 4 plans crossed with 2 tile x 2 DRAM rates."""
    api = side.api
    defaults = dict(
        arch="yi-6b",
        hardware=side.core.tpu_v5e_pod(2, 2),
        seq_len=128,
        global_batch=8,
        search=api.SearchSpace(max_plans=4, microbatch_sizes=(1,)),
        hardware_search=api.HardwareSearchSpace(tile_flops=(100e12, 197e12),
                                                dram_bandwidth=(400e9, 819e9)),
    )
    defaults.update({k: (v(api) if callable(v) else v) for k, v in kw.items()})
    return api.Experiment(**defaults)


def _both(fn):
    """``fn(side)`` for the reference and the port."""
    return [fn(side) for side in SIDES]


def _sweeps(**kw):
    """The same ``Experiment.sweep(**kw)`` through both packages."""
    return _both(lambda s: _exp(s).sweep(**kw, **s.dev))


def _error(fn):
    """(type name, message) of what ``fn()`` raises."""
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value).__name__, str(err.value)


# ---------------------------------------------------------------------------
# EncodedSpace
# ---------------------------------------------------------------------------

def test_encoded_space_matches_exhaustive_enumeration():
    ref, port = _both(lambda s: s.search.EncodedSpace.from_experiment(_exp(s)))
    report = _exp(PORT).sweep(workers=0, device="cpu")
    assert len(port) == len(ref) == report.num_candidates
    assert len(port.specs) == report.num_hardware
    assert [s.to_json() for s in port.specs] == [s.to_json() for s in ref.specs]
    assert repr(port) == repr(ref) and port.describe() == ref.describe()
    # flat order is the exhaustive job stream: variant-major, plan-minor
    jobs = port.jobs()
    assert [(v, T_plan_to_dict(p)) for v, p in jobs] == \
        [(v, R_plan_to_dict(p)) for v, p in ref.jobs()]
    for i, (v, plan) in enumerate(jobs):
        cand = port.from_flat(i)
        assert cand.key == ref.from_flat(i).key
        assert port.flat_index(cand) == i
        assert port.job(cand) == (v, plan)
    assert port.describe()["hardware_axes"] == {"tile_flops": 2, "dram_bandwidth": 2}


def test_encoded_space_counts_failed_variants():
    ref, port = _both(lambda s: s.search.EncodedSpace.from_experiment(_exp(
        s, search=lambda a: a.SearchSpace(degrees=[(2, 2, 1)], microbatch_sizes=(1,),
                                          layouts=(a.Layout.S_SHAPE,)),
        hardware_search=lambda a: a.HardwareSearchSpace(mesh_shapes=((2, 2), (1, 2))))))
    assert (port.extra_failed, port.num_enumerated, len(port.specs)) == \
        (ref.extra_failed, ref.num_enumerated, len(ref.specs)) == (1, 2, 1)


def test_encoded_space_sample_and_mutate_are_seed_deterministic():
    """``random.Random(seed)`` is the only source of randomness, so the
    port samples and mutates draw for draw as the reference does."""
    draws = []
    for side in SIDES:
        space = side.search.EncodedSpace.from_experiment(_exp(side))
        rng = random.Random(7)
        samples = [space.sample(rng) for _ in range(20)]
        mutants = [space.mutate(c, rng) for c in samples]
        many = space.sample_many(rng, 5)
        draws.append(([c.key for c in samples], [c.key for c in mutants],
                      [c.key for c in many], rng.random()))
        for src, dst in zip(samples, mutants):
            assert dst != src
            v, plan = space.job(dst)            # every mutant decodes to a job
            assert plan in space.plans[v]
    assert draws[1] == draws[0]


def test_fidelity_apply_truncates_microbatches_only():
    ref, port = _both(lambda s: s.api.ParallelPlan(pp=2, dp=2, tp=1, microbatch=1,
                                                   global_batch=16))
    assert port.num_microbatches == 8
    lows = [s.search.Fidelity("mb2", max_microbatches=2).apply(p)
            for s, p in zip(SIDES, (ref, port))]
    assert T_plan_to_dict(lows[1]) == R_plan_to_dict(lows[0])
    assert lows[1].num_microbatches == 2
    assert (lows[1].microbatch, lows[1].dp, lows[1].pp) == (1, 2, 2)
    assert TS.FULL.apply(port) is port
    # already-short plans are untouched
    assert TS.Fidelity("mb16", max_microbatches=16).apply(port) is port


def test_unnamed_reduced_fidelity_gets_derived_name_and_cannot_poison_cache():
    """A reduced rung left with the default name must not masquerade as
    "full": the accounting name is derived, and run_search keys its
    evaluation cache on the Fidelity object, so a custom ladder with
    sloppy names still dispatches real full-fidelity sims."""
    f = TS.Fidelity(noc_mode=TA.NoCMode.ANALYTICAL)       # name not given
    assert f.name == RS.Fidelity(noc_mode=RA.NoCMode.ANALYTICAL).name
    assert f.name != "full" and not f.is_full
    ref, port = _both(lambda s: s.search.run_search(
        _exp(s), strategy="sh", budget=2, seed=0,
        ladder=[s.search.Fidelity(noc_mode=s.api.NoCMode.ANALYTICAL), s.search.FULL],
        **s.dev))
    assert port.to_json() == ref.to_json()
    assert port.runs, "full-fidelity rung must have dispatched real sims"
    assert port.search.full_fidelity_sims > 0
    assert port.search.sims_per_fidelity.get("full") == port.search.full_fidelity_sims


def test_default_ladder_ends_full_and_steps_down_detailed():
    for mode, rungs in (("detailed", 3), ("macro", 3), ("analytical", 3), ("macro", 2),
                        ("detailed", 1)):
        ref, port = _both(lambda s: s.search.default_ladder(s.api.NoCMode(mode), rungs))
        assert [(f.name, str(f.noc_mode), f.max_microbatches, f.max_requests, f.engine)
                for f in port] == \
            [(f.name, str(f.noc_mode), f.max_microbatches, f.max_requests, f.engine)
             for f in ref]
    ladder = TS.default_ladder(TA.NoCMode.DETAILED)
    assert [f.is_full for f in ladder] == [False, False, True]
    assert ladder[0].noc_mode == TA.NoCMode.ANALYTICAL
    assert ladder[1].noc_mode == TA.NoCMode.MACRO
    assert len(TS.default_ladder(TA.NoCMode.MACRO, num_rungs=2)) == 2
    assert _error(lambda: TS.default_ladder(num_rungs=4)) == \
        _error(lambda: RS.default_ladder(num_rungs=4))


# ---------------------------------------------------------------------------
# strategies: exhaustive parity, budget, determinism
# ---------------------------------------------------------------------------

def test_exhaustive_strategy_is_bit_identical_to_legacy_sweep():
    """``strategy="exhaustive"`` is the exhaustive path, in both packages."""
    ref, port = _sweeps(workers=0, strategy="exhaustive")
    assert port.to_json() == ref.to_json() == \
        _exp(PORT).sweep(workers=0, device="cpu").to_json()


def test_random_search_respects_budget_and_seed():
    ref, port = _sweeps(workers=0, strategy="random", search_budget=5, seed=3)
    assert port.to_json() == ref.to_json()
    s = port.search
    assert s is not None and s.strategy == "random"
    assert s.full_fidelity_sims <= 5
    assert len(port.runs) <= 5
    assert sorted(s.sims_per_fidelity) == ["full"]
    again = _exp(PORT).sweep(workers=0, strategy="random", search_budget=5, seed=3,
                             device="cpu")
    assert again.to_json() == port.to_json()


def test_sh_finds_rigged_optimum_within_budget():
    """Rigged space: the 197T/819G variant dominates; successive halving
    must find a within-2% point with a fifth of the full-fidelity sims."""
    exhaustive = _exp(PORT).sweep(workers=0, device="cpu")
    budget = max(1, exhaustive.num_candidates // 5)
    ref, port = _sweeps(workers=0, strategy="sh", search_budget=budget, seed=0)
    assert port.to_json() == ref.to_json()
    s = port.search
    assert s.full_fidelity_sims <= budget
    assert port.best.throughput >= 0.98 * exhaustive.best.throughput
    # multi-fidelity: the cheap rungs did the bulk of the evaluations
    assert s.sims_per_fidelity.get("analytical-mb2", 0) > s.full_fidelity_sims
    # best-so-far curve is monotone in both coordinates
    curve = s.best_curve
    assert curve and all(a[0] <= b[0] and a[1] <= b[1] for a, b in zip(curve, curve[1:]))


def _drive_sh(side, budget=3):
    """Successive halving on synthetic monotone results (higher flat index
    = faster); returns (rung sizes, asks per rung, rung records)."""
    space = side.search.EncodedSpace.from_experiment(_exp(side))
    ladder = side.search.default_ladder()
    sh = side.search.SuccessiveHalving(space, budget=budget, seed=0, ladder=ladder, eta=2)
    sizes, asked = list(sh._rung_sizes), []
    while True:
        asks = sh.ask()
        if not asks:
            break
        rung = sh._rung
        assert len(asks) <= sizes[rung]
        assert all(f.name == ladder[rung].name for _, f in asks)
        asked.append([(c.key, f.name) for c, f in asks])
        sh.tell([side.search.EvalOutcome(c, f, ok=True, throughput=float(space.flat_index(c)))
                 for c, f in asks])
    return sizes, asked, [r.to_dict() for r in sh.rung_records()], len(ladder)


def test_sh_never_promotes_past_rung_budget():
    """Each rung promotes at most its successor's cohort budget, and the
    full-fidelity rung never exceeds the budget."""
    budget = 3
    ref, port = _both(_drive_sh)
    assert port == ref
    sizes, _, recs, rungs = port
    assert sizes[-1] <= budget
    assert len(recs) == rungs
    for prev, nxt in zip(recs, recs[1:]):
        assert prev["promoted"] == nxt["evaluated"]
        assert prev["promoted"] <= prev["evaluated"]
    assert recs[-1]["evaluated"] <= budget
    assert recs[-1]["promoted"] == 0


def test_evolve_respects_budget_and_finds_optimum():
    ref, port = _sweeps(workers=0, strategy="evolve", search_budget=10, seed=0)
    assert port.to_json() == ref.to_json()
    s = port.search
    assert s.full_fidelity_sims <= 10
    assert "197T" in port.best.hardware
    assert s.rungs and all(r.fidelity == "full" for r in s.rungs)


@pytest.fixture(scope="module")
def pool():
    """One spawned pool of 2 for every pooled guided search of the module."""
    with TA.SweepEngine(workers=2, device="cpu") as eng:
        yield eng


@pytest.mark.parametrize("strategy", ["random", "sh", "evolve"])
def test_fixed_seed_serial_matches_pool(strategy, pool):
    """Fixed-seed guided runs are bit-reproducible across executors (serial
    against a persistent spawned pool), and the serial run equals the
    reference's."""
    ref, serial = _sweeps(workers=0, strategy=strategy, search_budget=4, seed=1)
    assert serial.to_json() == ref.to_json()
    pooled = _exp(PORT).sweep(strategy=strategy, search_budget=4, seed=1, engine=pool)
    assert pooled.executor.startswith("process")
    ds, dp = serial.to_dict(), pooled.to_dict()
    ds.pop("executor"), dp.pop("executor")
    assert ds == dp


def test_empty_space_matches_exhaustive_empty_report():
    """An infeasible space yields an empty ranked report (CLI exit 1), not
    an error — same contract as the exhaustive path."""
    kw = dict(search=lambda a: a.SearchSpace(degrees=[(2, 2, 1)], microbatch_sizes=(1,),
                                             layouts=(a.Layout.S_SHAPE,)),
              hardware_search=lambda a: a.HardwareSearchSpace(mesh_shapes=((1, 2),)))
    exhaustive = _exp(PORT, **kw).sweep(workers=0, device="cpu")
    ref, guided = _both(lambda s: _exp(s, **kw).sweep(
        workers=0, strategy="random", search_budget=2, seed=0, **s.dev))
    assert guided.to_json() == ref.to_json()
    assert exhaustive.runs == [] and guided.runs == []
    assert guided.num_failed == exhaustive.num_failed == 1
    assert guided.num_candidates == exhaustive.num_candidates == 0
    assert guided.hardware == exhaustive.hardware
    assert guided.search.full_fidelity_sims == 0
    assert guided.best is None


def test_make_strategy_rejects_unknown():
    ref, port = _both(lambda s: _error(lambda: s.search.make_strategy(
        "bayes", s.search.EncodedSpace.from_experiment(_exp(s)), budget=4)))
    assert port == ref and port[0] == "ValueError" and "unknown search strategy" in port[1]


def test_search_budget_without_strategy_raises():
    """Budget/seed on an exhaustive sweep must fail loudly, not silently
    run the whole product — in the API and in the planner alike."""
    cases = [lambda s: _exp(s).sweep(search_budget=4, **s.dev),
             lambda s: _exp(s).sweep(seed=1, **s.dev),
             lambda s: s.api.plan_parallelism(
                 s.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2),
                 s.api.PlannerCfg(global_batch=8, seq_len=128, max_plans=2, search_budget=4))]
    for case in cases:
        ref, port = _both(lambda s: _error(lambda: case(s)))
        assert port == ref and port[0] == "ValueError" and "guided search" in port[1]


def test_search_report_round_trips_inside_sweep_report():
    ref, port = _sweeps(workers=0, strategy="sh", search_budget=3, seed=0)
    assert port.to_json() == ref.to_json()
    back = TA.SweepReport.from_json(port.to_json())
    assert back == port
    assert isinstance(back.search, TS.SearchReport)
    assert back.search == port.search
    assert back.search.rungs == port.search.rungs
    # the reference's report reads back in the port, and the port's in the reference
    assert TA.SweepReport.from_json(ref.to_json()).to_json() == ref.to_json()
    assert RA.SweepReport.from_json(port.to_json()).to_json() == port.to_json()
    assert TS.SearchReport.from_json(port.search.to_json()) == port.search
    assert port.search.summary() == ref.search.summary()
    # the winning variant is still recoverable (co-design contract)
    assert port.best_hardware_dict() is not None


def test_run_search_without_hardware_search():
    """Plan-only spaces search too (single variant, plan axes only)."""
    ref, port = _both(lambda s: s.search.run_search(
        _exp(s, hardware_search=None,
             search=lambda a: a.SearchSpace(max_plans=6, microbatch_sizes=(1, 2))),
        strategy="random", budget=3, seed=0, **s.dev))
    assert port.to_json() == ref.to_json()
    assert port.num_hardware == 1 and port.hardware == "tpu_v5e_2x2"
    assert port.search.full_fidelity_sims <= 3 and port.runs


def _guided_codesign_cfg(side, **kw):
    return side.api.PlannerCfg(
        global_batch=8, seq_len=128, max_plans=3, microbatch_sizes=(1,),
        hardware_search=side.api.HardwareSearchSpace(tile_flops=(100e12, 197e12)),
        search_strategy="sh", search_budget=2, search_seed=0, **kw)


def test_plan_codesign_with_guided_strategy():
    ref, port = _both(lambda s: s.api.plan_codesign(
        s.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2), _guided_codesign_cfg(s), **s.dev))
    assert port.to_json() == ref.to_json()
    assert port.report.to_json() == ref.report.to_json()
    assert "197T" in port.hardware.name
    assert port.report.search is not None
    assert port.report.search.full_fidelity_sims <= 2


# ---------------------------------------------------------------------------
# sweep-engine trace lane filter / payload budget
# ---------------------------------------------------------------------------

def _timeline_plans(side):
    api = side.api
    exp = api.Experiment(arch="yi-6b", hardware=side.core.tpu_v5e_pod(2, 2), seq_len=128,
                         global_batch=8, collect_timeline=True,
                         search=api.SearchSpace(max_plans=3, microbatch_sizes=(1,),
                                                layouts=(api.Layout.S_SHAPE,)))
    return exp, exp.search.enumerate_plans(exp.hardware_spec, exp.global_batch,
                                           arch=exp.arch_config)


def _lane_sweep(side, workers=0, **kw):
    exp, plans = _timeline_plans(side)
    eng = side.api.SweepEngine(workers=workers, return_timelines=True, trace_resources=True,
                               **kw, **side.dev)
    try:
        return eng.sweep(exp, plans)
    finally:
        eng.close()


def _traces(report):
    return [(r.trace.to_bytes(), r.extra) for r in report.runs]


def test_trace_lane_filter_keeps_scalars_exact():
    full = _lane_sweep(PORT)
    ref, lean = _both(lambda s: _lane_sweep(s, trace_lanes=("FD", "BD")))
    assert lean.to_json() == ref.to_json() and _traces(lean) == _traces(ref)
    assert [r.plan for r in lean.runs] == [r.plan for r in full.runs]
    assert [r.throughput for r in lean.runs] == [r.throughput for r in full.runs]
    # scalars were digested before filtering: bubble/occupancy stay exact
    assert [r.bubble_ratio for r in lean.runs] == [r.bubble_ratio for r in full.runs]
    for r in lean.runs:
        assert {int(k) for k in r.trace.kind} <= {0, 1}      # FD, BD only
    assert sum(r.trace.nbytes for r in lean.runs) < sum(r.trace.nbytes for r in full.runs)


def test_trace_budget_bounds_payload_and_records_drops():
    budget = 2000
    ref, rep = _both(lambda s: _lane_sweep(s, trace_budget_bytes=budget))
    assert rep.to_json() == ref.to_json() and _traces(rep) == _traces(ref)
    for r in rep.runs:
        assert r.trace.nbytes <= budget
        dropped = r.extra.get("trace_lanes_dropped", [])
        assert dropped, "tight budget must have dropped lanes"
        assert dropped == sorted(dropped, key=["DRAM", "NOC", "GU", "BD", "FD"].index)
    # serial and pooled engines apply the identical policy
    pooled = _lane_sweep(PORT, workers=2, trace_budget_bytes=budget)
    assert all(a.trace == b.trace and a.extra == b.extra
               for a, b in zip(rep.runs, pooled.runs))


def test_trace_lanes_rejects_unknown_names():
    ref, port = _both(lambda s: _error(lambda: s.api.SweepEngine(
        trace_lanes=("FD", "PCIE"), **s.dev)))
    assert port == ref and port[0] == "ValueError" and "unknown trace lane" in port[1]


# ---------------------------------------------------------------------------
# the port's rule: ``device`` on the planners is for guided search only
# ---------------------------------------------------------------------------

EXHAUSTIVE_PLANNERS = {
    "plan_parallelism": lambda **kw: TA.plan_parallelism(
        T_get_config("yi-6b"), TC.tpu_v5e_pod(2, 2),
        TA.PlannerCfg(global_batch=8, seq_len=128, max_plans=2), **kw),
    "plan_codesign": lambda **kw: TA.plan_codesign(
        T_get_config("yi-6b"), TC.tpu_v5e_pod(2, 2),
        dataclasses.replace(_guided_codesign_cfg(PORT), search_strategy="exhaustive",
                            search_budget=None, search_seed=None), **kw),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("what", sorted(EXHAUSTIVE_PLANNERS))
def test_exhaustive_planner_refuses_a_device(what, device):
    with pytest.raises(ValueError, match="device only applies to guided search"):
        EXHAUSTIVE_PLANNERS[what](device=device)


GUIDED_WITHOUT_A_DEVICE = {
    "plan_parallelism strategy": lambda: TA.plan_parallelism(
        T_get_config("yi-6b"), TC.tpu_v5e_pod(2, 2),
        TA.PlannerCfg(global_batch=8, seq_len=128, max_plans=2), strategy="random"),
    "plan_codesign cfg": lambda: TA.plan_codesign(
        T_get_config("yi-6b"), TC.tpu_v5e_pod(2, 2), _guided_codesign_cfg(PORT)),
    "Experiment.sweep": lambda: _exp(PORT).sweep(strategy="sh", search_budget=2),
    "run_search": lambda: TS.run_search(_exp(PORT), strategy="evolve", budget=2),
}


@pytest.mark.parametrize("what", sorted(GUIDED_WITHOUT_A_DEVICE))
def test_guided_search_without_a_device_means_the_card(monkeypatch, what):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        GUIDED_WITHOUT_A_DEVICE[what]()


def test_guided_planner_on_the_cpu_batches_its_reduced_rungs():
    """A guided planner's reduced rungs run ``engine="auto"`` and take the
    fast tier (groups of ``min_group`` jobs or more batched on ``device``,
    smaller ones scalar); its full rung runs the experiment's event
    engine. On the CPU nothing launches."""
    from repro_torch import kernels
    shared = TA.shared_engine(workers=0, device="cpu")     # the planner's engine
    before = dict(shared.profile_totals)
    kernels.reset_launch_counts()
    res = TA.plan_codesign(T_get_config("yi-6b"), TC.tpu_v5e_pod(2, 2),
                           _guided_codesign_cfg(PORT), device="cpu")
    assert kernels.launch_counts()["chain_replay"] == 0
    rungs = res.report.search.sims_per_fidelity
    assert set(rungs) == {"analytical-mb2", "macro-mb4", "full"}
    fast = {k: shared.profile_totals.get(k, 0) - before.get(k, 0)
            for k in ("batched_jobs", "scalar_jobs")}
    assert fast["batched_jobs"] > 0
    assert sum(fast.values()) == rungs["analytical-mb2"] + rungs["macro-mb4"]
    assert all(r.extra.get("engine", "event") == "event" for r in res.report.runs)
