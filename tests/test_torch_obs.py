"""The port's sim-domain metrics (``repro_torch.obs``) against the reference
(``repro.obs``): the registry's documents, merges and text for the same
recorded counts; ``sim_metrics``/``run_metrics`` on the same simulations
(equal to the reference's, and equal between the port's fast and event
tiers), ``payload_by_level`` on ``tiled_cluster``, the counter tracks on
the Chrome export, ``aggregate_run_metrics`` on the same outcome lists,
the serving documents of one reference serving report, and the metrics
documents of the port's sweeps (serial and pooled), guided searches and
serving reports against the reference's. Its numpy-less fallback has no
counterpart here."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as RA  # noqa: E402
import repro.core as R  # noqa: E402
import repro.obs as RO  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro.core.hardware import tiled_cluster as R_tiled_cluster  # noqa: E402
from repro.core.workload import arch_to_graph as R_arch_to_graph  # noqa: E402
from repro.serving.system import ServingSpec, simulate_serving  # noqa: E402
from repro.serving.workload import WorkloadSpec  # noqa: E402

import repro_torch.api as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch.configs import get_config as T_get_config  # noqa: E402
from repro_torch.core.fastpath import FastPathIneligible  # noqa: E402
from repro_torch.core.hardware import tiled_cluster as T_tiled_cluster  # noqa: E402
from repro_torch.core.workload import arch_to_graph as T_arch_to_graph  # noqa: E402
from repro_torch.serving.system import ServingSpec as T_ServingSpec  # noqa: E402
from repro_torch.serving.system import simulate_serving as T_simulate_serving  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec as T_WorkloadSpec  # noqa: E402

# (core, obs, tiled_cluster, arch_to_graph, get_config)
REF = (R, RO, R_tiled_cluster, R_arch_to_graph, R_get_config)
PORT = (T, TO, T_tiled_cluster, T_arch_to_graph, T_get_config)
SIDES = (REF, PORT)
HW = "tpu_v5e_2x2"         # tpu_v5e_pod(2, 2), as the reference's API names it


def _sim(side, plan=(2, 1, 2), micro=1, gb=8, engine="auto", metrics=True, hw=HW,
         mode="macro", timeline=False, arch="yi-6b"):
    """The reference test's Experiment as a plain simulator: full-width
    ``arch`` at sequence 128, training, on ``HW`` or ``tiled_cluster``."""
    core, _, tiled_cluster, arch_to_graph, get_config = side
    pp, dp, tp = plan
    p = core.ParallelPlan(pp=pp, dp=dp, tp=tp, microbatch=micro, global_batch=gb)
    graph = arch_to_graph(get_config(arch), 128, micro * dp, training=True)
    hardware = tiled_cluster() if hw == "tiled_cluster" else core.tpu_v5e_pod(2, 2)
    return core.PipelineSimulator(core.map_graph(graph, hardware, p), noc_mode=core.NoCMode(mode),
                                  engine=engine, metrics=metrics, collect_timeline=timeline)


def _both_runs(**kw):
    return [_sim(side, **kw).run() for side in SIDES]


def _doc(metrics):
    return json.dumps(metrics, sort_keys=True)


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def _record(obs):
    reg = obs.MetricsRegistry()
    reg.counter("host.sweep.jobs").inc(3)
    reg.counter("host.sweep.jobs").inc(2)
    reg.counter("sim.bytes").inc(0.1)
    reg.counter("sim.bytes").inc(0.2)
    reg.gauge("host.pool.workers").set(4)
    reg.gauge("host.peak").high(7.5)
    reg.gauge("host.peak").high(2.0)
    for x in (10.0, 30.0, 0.3):
        reg.histogram("host.shard.us").observe(x)
    with reg.span("host.evaluate"):
        pass
    return reg


def _without_span_us(doc):
    """A registry document less the spans' wall-clock microseconds."""
    return {k: ({n: v for n, v in d.items() if not n.endswith(".us")} if k == "counters" else d)
            for k, d in doc.items()}


def test_registry_roundtrip_and_merge():
    ref, port = (_record(obs).to_dict() for obs in (RO, TO))
    assert _without_span_us(port) == _without_span_us(ref)
    assert port["counters"]["host.sweep.jobs"] == 5
    assert port["counters"]["host.evaluate.calls"] == 1
    assert port["histograms"]["host.shard.us"] == {"count": 3, "sum": 40.3, "min": 0.3,
                                                   "max": 30.0}
    # exact round trip, and each package reads the other's document
    assert TO.MetricsRegistry.from_dict(port).to_dict() == port
    assert TO.MetricsRegistry.from_dict(ref).to_dict() == RO.MetricsRegistry.from_dict(
        ref).to_dict()
    # merge: counters add, gauges last-write, histograms combine exactly
    merged = []
    for obs in (RO, TO):
        other = obs.MetricsRegistry()
        other.counter("host.sweep.jobs").inc(7)
        other.gauge("host.pool.workers").set(2)
        other.histogram("host.shard.us").observe(5.0)
        other.histogram("host.other").observe(1.5)
        other.merge_dict(ref)
        merged.append(other.to_dict())
    assert merged[1] == merged[0]
    assert merged[1]["counters"]["host.sweep.jobs"] == 12
    assert merged[1]["gauges"]["host.pool.workers"] == 4
    assert merged[1]["histograms"]["host.shard.us"]["count"] == 4
    assert list(TO.MetricsRegistry.from_dict(merged[1]).rows()) == \
        list(RO.MetricsRegistry.from_dict(merged[0]).rows())


def test_registry_rejects_unprefixed_names():
    for bad in ("jobs", "sweep.jobs", "simjobs", "hostile.jobs"):
        msgs = []
        for obs in (RO, TO):
            with pytest.raises(ValueError) as err:
                obs.MetricsRegistry().counter(bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    reg = TO.MetricsRegistry()
    reg.counter("sim.total_time")
    reg.counter("host.sweep.jobs")


def test_null_registry_is_falsy_noop():
    assert not TO.NULL_REGISTRY
    assert TO.make_registry(False) is TO.NULL_REGISTRY
    assert isinstance(TO.make_registry(True), TO.MetricsRegistry)
    TO.NULL_REGISTRY.counter("host.x").inc(5)
    TO.NULL_REGISTRY.gauge("host.y").set(1)
    TO.NULL_REGISTRY.histogram("host.z").observe(2.0)
    with TO.NULL_REGISTRY.span("host.w"):
        pass
    assert TO.NULL_REGISTRY.to_dict() == {}
    assert TO.NULL_REGISTRY.rows() == []


# ---------------------------------------------------------------------------
# the process's current registry: recording, current, span
# ---------------------------------------------------------------------------

def test_span_off_path_is_the_shared_null_span_and_allocates_nothing():
    import tracemalloc
    from repro_torch.obs import registry

    assert registry.current() is TO.NULL_REGISTRY
    assert registry.span("host.train.forward") is registry._NULL_SPAN

    def spans(n):
        for _ in range(n):
            with registry.span("host.train.forward"):
                pass

    def held(n):                      # the same loop around the shared span itself
        null = registry._NULL_SPAN
        for _ in range(n):
            with null:
                pass

    def peak_rise(loop):
        """The traced peak's rise over a loop of 10,000: a transient
        allocation a call shows as its size."""
        loop(10)
        tracemalloc.start()
        try:
            loop(10)
            tracemalloc.reset_peak()
            start = tracemalloc.get_traced_memory()[0]
            loop(10_000)
            return tracemalloc.get_traced_memory()[1] - start
        finally:
            tracemalloc.stop()
    assert peak_rise(spans) == peak_rise(held)


def test_spans_nest_and_fold_us_and_calls():
    from repro_torch.obs import registry

    reg = TO.MetricsRegistry()
    with registry.recording(reg) as installed:
        assert installed is reg and registry.current() is reg
        for _ in range(3):
            with registry.span("host.train.backward"):
                with registry.span("host.train.forward"):
                    pass
        with registry.span("host.train.forward"):
            pass
    counters = reg.to_dict()["counters"]
    assert counters["host.train.backward.calls"] == 3
    assert counters["host.train.forward.calls"] == 4
    assert counters["host.train.backward.us"] > 0 and counters["host.train.forward.us"] > 0
    assert registry.current() is TO.NULL_REGISTRY


def test_module_span_names_keep_the_domain_prefix():
    from repro_torch.obs import registry

    with registry.recording(TO.MetricsRegistry()):
        for bad in ("train.forward", "forward", "hostile.forward"):
            with pytest.raises(ValueError):
                registry.span(bad)
    registry.span("forward")            # the null registry records nothing and checks nothing


def test_span_marks_the_profiler_only_while_it_records():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import registry

    reg = TO.MetricsRegistry()
    with registry.recording(reg):
        with registry.span("host.serve.prefill"):          # no profiler: no record
            torch.ones(4).add_(1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with registry.span("host.train.backward"):
                with registry.span("host.train.forward"):
                    torch.ones(4).add_(1)
        with registry.span("host.train.apply_optimizer"):   # after the profiler
            torch.ones(4).add_(1)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        with registry.span("host.train.sync_model"):         # no registry: no record
            torch.ones(4).add_(1)
    names = [e.name for e in prof.events() if e.name.startswith("host.")]
    assert sorted(names) == ["host.train.backward", "host.train.forward"]
    outer = next(e for e in prof.events() if e.name == "host.train.backward")
    inner = next(e for e in prof.events() if e.name == "host.train.forward")
    assert outer.time_range.start <= inner.time_range.start <= inner.time_range.end \
        <= outer.time_range.end
    assert not [e.name for e in off.events() if e.name.startswith("host.")]
    assert reg.to_dict()["counters"]["host.serve.prefill.calls"] == 1
    assert reg.to_dict()["counters"]["host.train.apply_optimizer.calls"] == 1


def test_recording_restores_the_previous_registry():
    from repro_torch.obs import registry

    outer, inner = TO.MetricsRegistry(), TO.MetricsRegistry()
    with registry.recording(outer):
        with pytest.raises(RuntimeError):
            with registry.recording(inner):
                assert registry.current() is inner
                with registry.span("host.train.forward"):
                    raise RuntimeError("inside the span")
        assert registry.current() is outer
        with registry.span("host.train.forward"):
            pass
    assert registry.current() is TO.NULL_REGISTRY
    assert inner.to_dict()["counters"]["host.train.forward.calls"] == 1
    assert outer.to_dict()["counters"]["host.train.forward.calls"] == 1


def test_summarize_metrics_text():
    a, b = _both_runs()
    text = TO.summarize_metrics(b.metrics, title="t")
    assert text == RO.summarize_metrics(a.metrics, title="t")
    assert text.startswith("== t ==")
    assert "[sim]" in text and "[host]" in text and "bubble_ratio" in text
    reg = _record(TO).to_dict()
    doc = {"sim": b.metrics["sim"], "host": _without_span_us(reg)}
    assert TO.summarize_metrics(doc) == RO.summarize_metrics(doc)
    assert "(none recorded" in TO.summarize_metrics(None)


# ---------------------------------------------------------------------------
# run documents: attached when enabled, nothing when disabled
# ---------------------------------------------------------------------------

def test_run_metrics_disabled_adds_nothing():
    res = _sim(PORT, metrics=False).run()
    assert res.metrics is None


def test_run_metrics_equal_reference_and_shape():
    a, b = _both_runs()
    assert _doc(b.metrics) == _doc(a.metrics)
    m = b.metrics
    assert set(m) == {"sim", "host"}
    assert m["sim"]["total_time"] == b.total_time
    assert m["sim"]["throughput"] == b.throughput
    assert len(m["sim"]["stages"]["flops"]) == 2
    assert m["host"]["engine"] in ("fast", "event")
    assert json.loads(json.dumps(m)) == m


def test_bubble_and_roofline_identities():
    res = _sim(PORT).run()
    sim = res.metrics["sim"]
    S = len(sim["stages"]["flops"])
    bub = sim["bubble"]
    assert bub["warmup"] + bub["interior"] + bub["drain"] + bub["busy"] == \
        S * sim["total_time"]
    assert sim["bubble_ratio"] == pytest.approx(res.bubble_ratio, rel=1e-12)
    denom = sim["total_time"] * T.tpu_v5e_pod(2, 2).tile.flops
    for u, f in zip(sim["stages"]["roofline_utilization"], sim["stages"]["flops"]):
        assert u == f / denom
        assert 0.0 < u < 1.0


def test_fastpath_rejection_code_surfaced():
    """tiled_cluster in the default macro NoC mode is fast-ineligible: auto
    takes the event tier and records why, as the reference does."""
    a, b = _both_runs(hw="tiled_cluster", gb=4)
    assert _doc(b.metrics) == _doc(a.metrics)
    host = b.metrics["host"]
    assert host["engine"] == "event"
    assert host["fastpath_rejection"]["code"] == "contention"
    assert "contention" in host["fastpath_rejection"]["reason"]


# ---------------------------------------------------------------------------
# sim-domain bit identity: packages, tiers, fabric levels
# ---------------------------------------------------------------------------

def _tier_cases(n=6, seed=11):
    """The reference property test's draws (seeded as its ``given``)."""
    plans = [(2, 1, 2), (1, 2, 2), (2, 2, 1), (4, 1, 1)]
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 10_000 + i)
        plan = plans[int(rng.integers(len(plans)))]
        out.append((plan, int(rng.choice([1, 2])), int(rng.choice([8, 16]))))
    return out


@pytest.mark.parametrize("case", _tier_cases(), ids=lambda c: "pp{}dp{}tp{}-mb{}-gb{}".format(
    *c[0], *c[1:]))
def test_sim_metrics_identical_across_tiers(case):
    plan, micro, gb = case
    event = [_sim(side, plan=plan, micro=micro, gb=gb, engine="event").run() for side in SIDES]
    assert _doc(event[1].metrics) == _doc(event[0].metrics)
    try:
        fast = _sim(PORT, plan=plan, micro=micro, gb=gb, engine="fast").run()
    except FastPathIneligible:
        return          # the draw needs the event tier; parity is vacuous
    assert _doc(fast.metrics["sim"]) == _doc(event[1].metrics["sim"])


def test_fabric_payload_by_level_parity():
    docs = {}
    for engine in ("fast", "event"):
        a, b = _both_runs(hw="tiled_cluster", gb=4, engine=engine, mode="analytical")
        assert b.metrics["host"]["engine"] == engine
        assert _doc(b.metrics) == _doc(a.metrics)
        docs[engine] = b.metrics["sim"]
    assert _doc(docs["fast"]) == _doc(docs["event"])
    levels = docs["fast"]["payload_by_level"]
    assert set(levels) == {"board", "node"} and all(v > 0 for v in levels.values())


@pytest.mark.parametrize("timeline", [True, False], ids=["timeline", "no_timeline"])
@pytest.mark.parametrize("mode", ["analytical", "macro", "detailed"])
@pytest.mark.parametrize("plan", [(1, 2, 2), (2, 1, 2), (2, 2, 2)],
                         ids=lambda p: "pp{}dp{}tp{}".format(*p))
def test_tiled_cluster_metrics_equal_reference(plan, mode, timeline):
    """``run_metrics`` on the fabric machine, in every NoC mode: the whole
    document equal to the reference's, resources with the fabric's lanes
    when timelines are on."""
    kw = dict(plan=plan, gb=4 * plan[1], hw="tiled_cluster", mode=mode, timeline=timeline,
              arch="minitron-4b")
    a, b = _both_runs(**kw)
    assert _doc(b.metrics) == _doc(a.metrics)
    sim = b.metrics["sim"]
    assert ("resources" in sim) == timeline
    if "payload_by_level" in sim:
        assert set(sim["payload_by_level"]) <= {"board", "node"}


# ---------------------------------------------------------------------------
# counter tracks and the Chrome export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [HW, "tiled_cluster"])
def test_chrome_trace_counter_tracks(hw):
    docs = []
    for side in SIDES:
        core, obs = side[0], side[1]
        res = _sim(side, hw=hw, gb=4, timeline=True, mode="detailed").run()
        counters = obs.activity_counters(res.trace)
        counters.update(obs.metrics_counters(res.metrics, res.trace.total_time))
        docs.append(json.dumps(core.chrome_trace(res.trace, counters=counters), sort_keys=True))
    assert docs[1] == docs[0]
    events = json.loads(docs[1])["traceEvents"]
    tracks = [e for e in events if e.get("ph") == "C"]
    names = {e["name"] for e in tracks}
    assert "active_stages" in names and "bubble_ratio" in names
    if hw == "tiled_cluster":
        assert {"busy_fabric_links", "payload_board_bytes", "payload_node_bytes"} <= names
    for e in tracks:
        assert e["pid"] == 5 and isinstance(e["args"]["value"], (int, float))
    by_name = {}
    for e in tracks:
        by_name.setdefault(e["name"], []).append(e["ts"])
    for ts in by_name.values():
        assert ts == sorted(ts)
    assert TO.activity_counters(None) == {} and TO.metrics_counters(None, 1.0) == {}


# ---------------------------------------------------------------------------
# sweep aggregate and serving documents
# ---------------------------------------------------------------------------

def test_aggregate_run_metrics_equals_reference():
    """The same outcome lists (tags as the reference's sweep engine writes
    them, payloads the reference's results) give the same aggregate."""
    results = [_sim(REF, plan=p, gb=gb, metrics=False).run()
               for p, gb in (((2, 1, 2), 8), ((1, 2, 2), 16), ((4, 1, 1), 8))]
    for outcomes in ([], [("ok", results[0])],
                     [("ok", results[0]), ("pruned", "memory"), ("ok", results[1]),
                      ("failed", "boom"), ("ok", results[2]), ("pruned", None)],
                     [("failed", "x"), ("pruned", None)]):
        assert TO.aggregate_run_metrics(outcomes) == RO.aggregate_run_metrics(outcomes)
    agg = TO.aggregate_run_metrics([("ok", r) for r in results] + [("pruned", None)])
    assert (agg["runs"], agg["pruned"], agg["failed"]) == (3, 1, 0)
    assert agg["best_throughput"] == max(r.throughput for r in results)


TINY_SPEC = ServingSpec(workload=WorkloadSpec(rate=2.0, num_requests=10, seed=3,
                                              prompt_mean=64, decode_mean=8,
                                              prompt_cv=0.5, decode_cv=0.5),
                        max_batch=4, ctx_bucket=128)


def test_serving_documents_equal_reference():
    """The port reads a serving report by its attributes: on the reference's
    report its sim document is the one the report carries, and its counter
    tracks the reference's; with a KV budget too."""
    rep = simulate_serving("hymba-1.5b", "grayskull", None, TINY_SPEC, metrics=True)
    doc = TO.serving_sim_metrics(rep)
    assert doc == RO.serving_sim_metrics(rep) == rep.metrics["sim"]
    assert doc["kv_cache"]["peak_bytes"] == rep.kv_peak_bytes
    assert doc["steps"]["decode"] == rep.steps["decode"]
    series = TO.serving_counters(rep)
    assert series == RO.serving_counters(rep)
    assert "kv_occupancy_bytes" in series and "queue_depth" in series
    budget = dataclasses.replace(rep, kv_budget_bytes=4 * rep.kv_peak_bytes)
    assert TO.serving_sim_metrics(budget) == RO.serving_sim_metrics(budget)
    assert TO.serving_sim_metrics(budget)["kv_cache"]["peak_fraction"] == 0.25
    empty = dataclasses.replace(rep, kv_occupancy_bytes=[], queue_depth=[])
    assert TO.serving_sim_metrics(empty) == RO.serving_sim_metrics(empty)
    assert TO.serving_counters(empty) == {}


# ---------------------------------------------------------------------------
# metrics through the Experiment API and the serving simulator
# ---------------------------------------------------------------------------

def _metrics_experiment(api, metrics=True, degrees=((2, 1, 2), (1, 2, 2), (2, 2, 1)),
                        micro=(1, 2)):
    return api.Experiment(arch="yi-6b", hardware=HW, seq_len=128, global_batch=8,
                          metrics=metrics, engine="auto",
                          search=api.SearchSpace(degrees=list(degrees), microbatch_sizes=micro))


def test_sim_metrics_identical_serial_vs_pool():
    exp = _metrics_experiment(TA)
    plans = exp.search.enumerate_plans(TA.resolve_hardware(HW), 8)
    reports = {}
    for workers in (0, 2):
        eng = TA.SweepEngine(workers=workers, device="cpu")
        try:
            reports[workers] = eng.sweep(exp, plans)
        finally:
            eng.close()
    a, b = reports[0], reports[2]
    ref_exp = _metrics_experiment(RA)
    ref = RA.SweepEngine(workers=0).sweep(
        ref_exp, ref_exp.search.enumerate_plans(RA.resolve_hardware(HW), 8))
    assert _doc(a.metrics["sim"]) == _doc(b.metrics["sim"]) == _doc(ref.metrics["sim"])
    assert [_doc(r.metrics["sim"]) for r in a.runs] == \
        [_doc(r.metrics["sim"]) for r in b.runs] == [_doc(r.metrics["sim"]) for r in ref.runs]
    assert a.metrics["host"]["counters"]["host.sweep.jobs"] == len(plans)
    assert b.metrics["host"]["counters"]["host.pool.shards"] >= 1
    assert TA.SweepReport.from_json(a.to_json()).metrics == a.metrics


def test_sweep_metrics_disabled_adds_nothing():
    reps = [_metrics_experiment(api, metrics=False, degrees=((2, 1, 2), (1, 2, 2)),
                                micro=(1,)).sweep(**dev)
            for api, dev in ((RA, {}), (TA, {"device": "cpu"}))]
    for rep in reps:
        assert rep.metrics is None and "metrics" not in rep.to_dict()
        assert all(r.metrics is None for r in rep.runs)
    assert reps[1].to_json() == reps[0].to_json()


def test_serving_metrics_attach_and_roundtrip():
    spec = T_ServingSpec(workload=T_WorkloadSpec(rate=2.0, num_requests=10, seed=3,
                                                 prompt_mean=64, decode_mean=8,
                                                 prompt_cv=0.5, decode_cv=0.5),
                         max_batch=4, ctx_bucket=128)
    rep = T_simulate_serving("hymba-1.5b", "grayskull", None, spec, metrics=True)
    ref = simulate_serving("hymba-1.5b", "grayskull", None, TINY_SPEC, metrics=True)
    m = rep.metrics
    assert set(m) == {"sim", "host"} and m["sim"] == ref.metrics["sim"]
    assert m["sim"]["kv_cache"]["peak_bytes"] == rep.kv_peak_bytes
    assert m["sim"]["steps"]["decode"] == rep.steps["decode"]
    assert m["host"]["counters"]["host.serving.run.calls"] == 1
    assert json.loads(json.dumps(rep.to_dict()))["metrics"] == m
    series = TO.serving_counters(rep)
    assert series == RO.serving_counters(ref)
    assert "kv_occupancy_bytes" in series and "queue_depth" in series
    off = T_simulate_serving("hymba-1.5b", "grayskull", None, spec)
    assert off.metrics is None and "metrics" not in off.to_dict()


def test_search_profile_and_metrics_promoted():
    """A guided search's profile has a row a generation and its metrics
    document the ranked full-fidelity runs (sim, equal to the reference's)
    and the search's own host counters."""
    from repro.search.engine import run_search as R_run_search
    from repro_torch.search.engine import run_search as T_run_search
    reps = []
    for api, run_search, dev in ((RA, R_run_search, {}), (TA, T_run_search, {"device": "cpu"})):
        exp = api.Experiment(arch="yi-6b", hardware=HW, seq_len=128, global_batch=8,
                             metrics=True, search=api.SearchSpace(
                                 degrees=[(2, 1, 2), (1, 2, 2), (2, 2, 1), (4, 1, 1)],
                                 microbatch_sizes=(1, 2)))
        reps.append(run_search(exp, strategy="sh", budget=6, seed=0, profile=True, **dev))
    ref, rep = reps
    prof = rep.profile
    assert prof is not None and prof["generations"]
    assert all("jobs" in g for g in prof["generations"])
    assert [g["jobs"] for g in prof["generations"]] == \
        [g["jobs"] for g in ref.profile["generations"]]
    m = rep.metrics
    assert m is not None
    assert m["sim"]["runs"] == len(rep.runs)
    assert _doc(m["sim"]) == _doc(ref.metrics["sim"])
    host = m["host"]["counters"]
    assert host["host.search.evaluations"] >= len(rep.runs)
    assert host["host.search.generation.calls"] == len(prof["generations"])
    assert host["host.search.evaluations"] == ref.metrics["host"]["counters"][
        "host.search.evaluations"]
