"""The port's serving simulator (``repro_torch.serving``: ``workload``,
``batcher``, ``system``, ``planner``) against the reference's
(``repro.serving``), mirroring ``tests/test_serving.py``: each case runs
the same arguments through both packages and asks for exact equality —
request lists, batcher states, reports as JSON, traces as bytes, errors
by message. The golden case holds the port's report equal to the
reference's live run, not to ``tests/data/serving_golden.json``: that
file was written under a Python whose ``sum`` of floats was a plain left
fold, and both packages take the mean with the builtin ``sum``, which is
compensated since Python 3.12 (ROADMAP.md §3)."""

import dataclasses
import importlib
import json
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")


def _side(pkg, dev):
    mods = {name: importlib.import_module(f"{pkg}.{path}") for name, path in (
        ("workload", "serving.workload"), ("batcher", "serving.batcher"),
        ("system", "serving.system"), ("planner", "serving.planner"), ("api", "api"),
        ("configs", "configs"), ("base", "configs.base"), ("trace", "core.trace"),
        ("core", "core"))}
    return SimpleNamespace(dev=dev, **mods)


REF = _side("repro", {})
PORT = _side("repro_torch", {"device": "cpu"})
SIDES = (REF, PORT)


def _both(fn):
    return [fn(side) for side in SIDES]


def _tiny_workload(s, **kw):
    args = dict(rate=2.0, num_requests=10, seed=3, prompt_mean=64, decode_mean=8,
                prompt_cv=0.5, decode_cv=0.5)
    args.update(kw)
    return s.workload.WorkloadSpec(**args)


def _tiny_spec(s, **kw):
    return s.system.ServingSpec(workload=_tiny_workload(s), max_batch=4, ctx_bucket=128, **kw)


def _rows(reqs):
    return [dataclasses.astuple(r) for r in reqs]


# ---------------------------------------------------------------------------
# workload generators
# ---------------------------------------------------------------------------

WORKLOADS = {
    "poisson": {},
    "poisson seed 4": dict(seed=4),
    "bursty": dict(kind="bursty"),
    "bursty factor": dict(kind="bursty", rate=3.0, num_requests=7, seed=9, burst_factor=2.5),
    "fixed lengths": dict(rate=1.0, num_requests=5, seed=0, prompt_mean=100, decode_mean=20,
                          prompt_cv=0.0, decode_cv=0.0),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_generates_the_reference_requests(name):
    ref, port = _both(lambda s: _tiny_workload(s, **WORKLOADS[name]))
    assert port.to_dict() == ref.to_dict()
    assert PORT.workload.WorkloadSpec.from_dict(port.to_dict()) == port
    reqs = port.generate()
    assert _rows(reqs) == _rows(ref.generate()) and reqs == port.generate()
    assert all(r.arrival <= s.arrival for r, s in zip(reqs, reqs[1:]))
    assert all(r.decode_len >= 1 for r in reqs)
    if name == "fixed lengths":
        assert {r.prompt_len for r in reqs} == {100} and {r.decode_len for r in reqs} == {20}
    text = PORT.workload.workload_to_json(reqs)
    assert text == REF.workload.workload_to_json(ref.generate())
    replay = PORT.workload.workload_from_json(text)
    assert replay.kind == "replay" and replay.generate() == reqs
    assert replay.offered_rate == REF.workload.workload_from_json(text).offered_rate
    span = reqs[-1].arrival - reqs[0].arrival
    assert replay.offered_rate == pytest.approx((len(reqs) - 1) / span)


def test_bursty_differs_from_poisson():
    poisson, bursty = (_tiny_workload(PORT, **WORKLOADS[n]).generate()
                       for n in ("poisson", "bursty"))
    assert len(bursty) == 10 and [r.arrival for r in bursty] != [r.arrival for r in poisson]


# ---------------------------------------------------------------------------
# KV-cache model and batcher policy
# ---------------------------------------------------------------------------

def _attn(s, **kw):
    base = dict(name="toy-attn", family="test", num_layers=4, d_model=256, n_heads=8, n_kv=4,
                d_ff=512, vocab=1000, head_dim=32)
    base.update(kw)
    return s.base.ArchConfig(**base)


def _ssm(s):
    return s.base.ArchConfig(name="toy-ssm", family="test", num_layers=2, d_model=256,
                             n_heads=8, n_kv=8, d_ff=512, vocab=1000, block="ssm",
                             ssm_state=64, d_inner=512, conv_width=4)


KV_ARCHS = {"attention": lambda s: _attn(s), "window": lambda s: _attn(s, window=16),
            "ssm": _ssm, "hymba": lambda s: s.configs.get_config("hymba-1.5b")}


@pytest.mark.parametrize("arch", sorted(KV_ARCHS))
def test_kv_cache_model_equals_reference(arch):
    ref, port = _both(lambda s: s.batcher.KVCacheModel.from_arch(KV_ARCHS[arch](s),
                                                                 precision_bytes=2))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for n in (1, 8, 10, 100, 10_000):
        assert port.request_bytes(n) == ref.request_bytes(n)
    if arch == "attention":
        assert port.per_token_bytes == 2 * 4 * 32 * 2 * 4 and port.fixed_bytes == 0
    if arch == "window":
        assert port.request_bytes(100) == 16 * port.per_token_bytes
    if arch == "ssm":
        assert port.per_token_bytes == 0 and port.fixed_bytes == 2 * 2 * (512 * 64 + 512 * 4)


def _state(b):
    """What a batcher shows: its queues, counters and each request's
    progress."""
    def req(a):
        return (a.rid, a.episode, a.context, a.generated, a.resume_context)
    return ([req(a) for a in b.running], [req(a) for a in b.waiting],
            [r.rid for r in b.rejected], b.preemptions)


def _reject_never_fits(s, b):
    out = [b.add(s.workload.Request(rid=0, arrival=0.0, prompt_len=8, decode_len=8),
                 now=0.0) is None]
    out.append(b.add(s.workload.Request(rid=1, arrival=0.0, prompt_len=4, decode_len=2),
                     now=0.0) is not None)
    return out + [_state(b)]


def _lifo_preemption(s, b):
    for rid in range(3):
        b.add(s.workload.Request(rid=rid, arrival=0.0, prompt_len=4, decode_len=10), now=0.0)
    admitted = b.admit(now=0.0)
    out = [[a.rid for a in admitted]]
    b.finish_prefill(admitted, now=1.0)
    b.finish_decode(now=2.0)
    retired, evicted = b.finish_decode(now=3.0)
    return out + [[a.rid for a in retired], [a.rid for a in evicted], _state(b)]


def _last_request_stays(s, b):
    b.add(s.workload.Request(rid=0, arrival=0.0, prompt_len=4, decode_len=8), now=0.0)
    admitted = b.admit(now=0.0)
    b.finish_prefill(admitted, now=1.0)
    out = []
    for step in range(6):
        _, evicted = b.finish_decode(now=2.0 + step)
        out.append(len(evicted))
    return out + [_state(b)]


def _static_drains(s, b):
    for rid in range(3):
        b.add(s.workload.Request(rid=rid, arrival=0.0, prompt_len=2, decode_len=2), now=0.0)
    first = b.admit(now=0.0)
    out = [[a.rid for a in first], b.admit(now=1.0)]
    b.finish_prefill(first, now=1.0)
    b.finish_decode(now=2.0)
    return out + [[a.rid for a in b.admit(now=3.0)], _state(b)]


# name -> (script, budget, max_batch, policy, what the reference test asserts)
BATCHER = {
    "rejects what never fits": (_reject_never_fits, 10.0, 4, "continuous",
                                lambda out: out[0] and out[1] and out[2][2] == [0]),
    "preempts LIFO": (_lifo_preemption, 20.0, 3, "continuous",
                      lambda out: out[0] == [0, 1, 2] and out[2] == [2]
                      and out[3][1][0][:3] == (2, 1, 0) and out[3][3] == 1),
    "never evicts the last": (_last_request_stays, 12.0, 2, "continuous",
                              lambda out: out[:6] == [0] * 6 and len(out[6][0]) == 1),
    "static drains": (_static_drains, 1e9, 2, "static",
                      lambda out: out[0] == [0, 1] and out[1] == [] and out[2] == [2]),
}


@pytest.mark.parametrize("case", sorted(BATCHER))
def test_batcher_equals_reference(case):
    script, budget, max_batch, policy, check = BATCHER[case]

    def run(s):
        kv = s.batcher.KVCacheModel(per_token_bytes=1.0, fixed_bytes=0.0)
        return script(s, s.batcher.ContinuousBatcher(kv, kv_budget_bytes=budget,
                                                     max_batch=max_batch, policy=policy))
    ref, port = _both(run)
    assert port == ref and check(port)


# ---------------------------------------------------------------------------
# the serving simulator
# ---------------------------------------------------------------------------

def _grayskull_kv(s):
    hw = s.api.resolve_hardware("grayskull")
    return s.batcher.KVCacheModel.from_arch(s.configs.get_config("hymba-1.5b"),
                                            hw.precision_bytes)


def _pressure(s, trace=False):
    workload = s.workload.WorkloadSpec(rate=50.0, num_requests=6, seed=0, prompt_mean=32,
                                       decode_mean=16)
    spec = s.system.ServingSpec(workload=workload, max_batch=4, ctx_bucket=64,
                                kv_budget_bytes=_grayskull_kv(s).request_bytes(48) * 2.8)
    return s.system.simulate_serving("hymba-1.5b", "grayskull", None, spec,
                                     collect_trace=trace)


def _too_large(s):
    workload = s.workload.WorkloadSpec(rate=10.0, num_requests=4, seed=0, prompt_mean=512,
                                       decode_mean=8)
    spec = s.system.ServingSpec(workload=workload, max_batch=4, ctx_bucket=64,
                                kv_budget_bytes=_grayskull_kv(s).request_bytes(100))
    return s.system.simulate_serving("hymba-1.5b", "grayskull", None, spec)


def _policy(s, policy):
    workload = s.workload.WorkloadSpec(rate=1.0, num_requests=24, seed=1, prompt_mean=64,
                                       prompt_cv=0.5, decode_mean=16, decode_cv=2.0)
    spec = s.system.ServingSpec(workload=workload, max_batch=4, ctx_bucket=128, policy=policy,
                                slo_ttft_ms=1500.0, slo_tpot_ms=250.0)
    return s.system.simulate_serving("hymba-1.5b", "grayskull", None, spec)


SERVING_RUNS = {
    "tiny": lambda s: s.system.simulate_serving("hymba-1.5b", "grayskull", None,
                                                _tiny_spec(s)),
    "metrics": lambda s: s.system.simulate_serving("hymba-1.5b", "grayskull", None,
                                                   _tiny_spec(s), metrics=True),
    "kv pressure": _pressure,
    "traced": lambda s: _pressure(s, trace=True),
    "too large": _too_large,
    "continuous": lambda s: _policy(s, "continuous"),
    "static": lambda s: _policy(s, "static"),
    "tp2 on yi-6b": lambda s: s.system.simulate_serving(
        "yi-6b", "tpu_v5e_2x2", s.core.ParallelPlan(pp=1, dp=1, tp=2, microbatch=1,
                                                    global_batch=1,
                                                    schedule=s.core.Schedule.GPIPE,
                                                    training=False),
        _tiny_spec(s), noc_mode="analytical"),
}


def _no_host(d):
    d = dict(d)
    if isinstance(d.get("metrics"), dict):
        d["metrics"] = {k: v for k, v in d["metrics"].items() if k != "host"}
    return d


@pytest.mark.parametrize("name", sorted(SERVING_RUNS))
def test_serving_report_equals_reference(name):
    ref, port = _both(SERVING_RUNS[name])
    assert _no_host(port.to_dict()) == _no_host(ref.to_dict())
    assert port.summary() == ref.summary()
    back = PORT.system.ServingReport.from_json(port.to_json())
    assert back.to_json() == port.to_json()
    assert (port.trace is None) == (ref.trace is None)
    if port.trace is not None:
        assert port.trace.to_bytes() == ref.trace.to_bytes()
    if name == "tiny":
        assert port.to_json() == SERVING_RUNS[name](PORT).to_json()
        assert port.completed == 10 and port.goodput_rps <= port.throughput_rps
        atts = [pt["attainment"] for pt in port.slo_curve]
        assert atts == sorted(atts) and 0.0 <= port.slo_attainment <= 1.0
    if name == "kv pressure":
        assert port.preemptions > 0 and port.completed == 6
        assert port.kv_peak_bytes <= port.kv_budget_bytes
    if name == "too large":
        assert port.rejected == 4 and port.completed == 0 and port.slo_attainment == 0.0
    if name == "metrics":           # tests/test_obs.py's serving document
        m = port.metrics
        assert set(m) == {"sim", "host"}
        assert m["sim"]["kv_cache"]["peak_bytes"] == port.kv_peak_bytes
        assert m["sim"]["steps"]["decode"] == port.steps["decode"]
        assert m["host"]["counters"]["host.serving.run.calls"] == 1
        assert json.loads(json.dumps(port.to_dict()))["metrics"] == m
        from repro_torch.obs.tracks import serving_counters
        series = serving_counters(port)
        assert "kv_occupancy_bytes" in series and "queue_depth" in series
    if name in ("tiny", "kv pressure"):
        assert port.metrics is None and "metrics" not in port.to_dict()


def test_serving_golden_report_equals_the_reference_live_run():
    """The reference's golden case, held to the reference's own run on
    this interpreter (module docstring)."""
    ref, port = _both(SERVING_RUNS["tiny"])
    assert port.to_dict() == ref.to_dict()


def test_continuous_beats_static_goodput_on_rigged_workload():
    assert _policy(PORT, "continuous").goodput_rps >= 1.5 * _policy(PORT, "static").goodput_rps


def _cost(s):
    plan = s.core.ParallelPlan(pp=1, dp=1, tp=1, microbatch=1, global_batch=1,
                               schedule=s.core.Schedule.GPIPE, training=False)
    return s.system.StepCostModel(s.configs.get_config("hymba-1.5b"),
                                  s.api.resolve_hardware("grayskull"), plan, ctx_bucket=128)


def test_step_cost_model_memoizes_by_bucket():
    def run(s):
        cost = _cost(s)
        a = cost.decode_cost(3, 100)
        out = [a, cost.decode_cost(4, 120), cost.sims]
        cost.decode_cost(4, 200)
        out.append(cost.sims)
        out += [cost.prefill_cost(4, 120), cost.sims, cost.derive_kv_budget()]
        return out
    ref, port = _both(run)
    assert port == ref
    assert port[0] == port[1] and port[2:4] == [1, 2] and port[4] != port[0]
    assert port[5] == 3 and math.isinf(port[6])


def test_serving_trace_lanes_npz_and_chrome(tmp_path):
    from repro_torch.core.trace import KIND_DECODE, KIND_PREFILL, KIND_QUEUE, Trace
    ref, port = _both(lambda s: _pressure(s, trace=True))
    trace = port.trace
    assert {KIND_PREFILL, KIND_DECODE, KIND_QUEUE} <= set(trace.kind)
    assert set(trace.stage) == {-1} and set(trace.resource) <= set(range(6))
    assert max(trace.micro) >= 1
    assert Trace.from_bytes(trace.to_bytes()).to_bytes() == trace.to_bytes()
    trace.to_npz(tmp_path / "serving.npz")
    assert Trace.from_npz(tmp_path / "serving.npz").to_bytes() == ref.trace.to_bytes()
    doc, want = (s.trace.chrome_trace(r.trace, label="serving")
                 for s, r in zip((PORT, REF), (port, ref)))
    assert doc == want
    req = [e for e in doc["traceEvents"] if e.get("pid") == 3 and e.get("ph") == "X"]
    assert any(e["name"].startswith("PREFILL ep") for e in req)
    assert any(e["name"].startswith("DECODE ep") for e in req)


# ---------------------------------------------------------------------------
# the serving-scored sweep and the planners
# ---------------------------------------------------------------------------

def _serving_experiment(s):
    return s.api.Experiment(
        arch="hymba-1.5b", hardware="grayskull",
        search=s.api.SearchSpace(degrees=[(1, 1, 4), (1, 2, 2), (1, 4, 1)],
                                 microbatch_sizes=(1,), layouts=(s.api.Layout.S_SHAPE,),
                                 max_plans=3),
        seq_len=128, global_batch=4, training=False, decode=True, serving=_tiny_spec(s))


def test_serving_sweep_equals_reference_serial_and_pooled():
    ref = _serving_experiment(REF).sweep(workers=0).to_dict()
    exp = _serving_experiment(PORT)
    serial = exp.sweep(workers=0, device="cpu").to_dict()
    pooled = exp.sweep(workers=2, device="cpu").to_dict()
    assert serial == ref
    assert serial.pop("executor") == "serial" and pooled.pop("executor") == "process[2]"
    assert serial == pooled
    goodputs = [r["throughput"] for r in serial["runs"]]
    assert goodputs == sorted(goodputs, reverse=True)
    for r in serial["runs"]:
        assert r["throughput"] == r["extra"]["serving"]["goodput_rps"]


def test_plan_serving_explains_infeasibility_as_the_reference():
    msgs = []
    for s in SIDES:
        with pytest.raises(RuntimeError) as err:
            s.planner.plan_serving("yi-6b", "tpu_v5e_2x2", batch=4, context_len=128,
                                   memory_cap=1e6)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert "no feasible serving split" in msgs[1] and "(dp=1, tp=4)" in msgs[1]
    assert "over the" in msgs[1] and "cap by" in msgs[1]


def test_plan_serving_equals_reference():
    ref, port = _both(lambda s: s.planner.plan_serving("yi-6b", "tpu_v5e_2x2", batch=4,
                                                       context_len=128, collect_timeline=True))
    assert port[0] == ref[0]
    assert port[1].to_json() == ref[1].to_json()
    for a, b in zip(port[1].runs, ref[1].runs):
        assert a.trace.to_bytes() == b.trace.to_bytes()


def _slo_cfg(s):
    slo = s.system.ServingSpec(
        workload=s.workload.WorkloadSpec(rate=8.0, num_requests=12, seed=0, prompt_mean=128,
                                         decode_mean=16),
        max_batch=4, ctx_bucket=128, slo_ttft_ms=500.0, slo_tpot_ms=8.0)
    return s.api.PlannerCfg(global_batch=32, seq_len=256, microbatch_sizes=(1,), max_plans=8,
                            slo=slo, hardware_search=s.api.HardwareSearchSpace(
                                mesh_shapes=((1, 4), (2, 2))))


@pytest.mark.parametrize("objective", ["throughput", "slo"])
def test_plan_codesign_objective_equals_reference(objective):
    ref, port = _both(lambda s: s.api.plan_codesign(
        s.configs.get_config("yi-6b"), s.core.tpu_v5e_pod(2, 2), _slo_cfg(s),
        objective=objective))
    assert port.to_json() == ref.to_json() and port.summary() == ref.summary()
    assert port.report.to_json() == ref.report.to_json()
    if objective == "slo":
        step = PORT.api.plan_codesign(PORT.configs.get_config("yi-6b"),
                                      PORT.core.tpu_v5e_pod(2, 2), _slo_cfg(PORT))
        assert (step.hardware.name, step.plan.tp) != (port.hardware.name, port.plan.tp)
        assert port.objective == "slo" and "req/s" in port.summary()
        assert port.run.extra["serving"]["slo"]["attainment"] > 0.5
