"""The hybrid configuration's helpers at tiny widths on the CPU: the draw
gives the port's leaves, the launches worked out from shapes are the
port's, the traffic's cycle is the one its file states, and the driver
runs set-up, a window and the check end to end."""

import copy
import dataclasses
from collections import Counter
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import hybrid, spec, traffic, trace
from portbench.flops import hybrid as work_hybrid, model

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite4h-prefill-longdoc"
TINY = {"num_layers": 4, "d_model": 64, "n_heads": 4, "n_kv": 2, "head_dim": 16, "vocab": 256,
        "n_experts": 8, "top_k": 2, "d_ff_expert": 32, "d_ff_shared": 32, "ssm_state": 16,
        "ssm_headdim": 16, "d_inner": 128, "layer_types": ["mamba", "mamba", "attention", "mamba"]}


def _cell(compute="float32"):
    c = spec.find_cell(spec.load_benchmark(ROOT), ROOT, CELL)
    config = copy.deepcopy(c.config)
    config["arch"].update(TINY)
    config["dtype"]["compute"] = config["dtype"]["weights"] = compute
    t = {**copy.deepcopy(c.traffic), "lengths": {"dist": "fixed", "length": 40, "count": 3},
         "checked_requests": 3}
    return dataclasses.replace(c, config=config, traffic=t)


def _port(c, seed=7):
    from repro_torch.models.lm import LM, RunCfg
    m = LM(spec.arch_of(c.config), RunCfg(compute_dtype=torch.float32, remat=False), "cpu")
    hybrid.load_into(dict(m.named_parameters()), hybrid.sizes_of(c.config), seed)
    return m


def test_the_cycle_of_the_traffic_file():
    c = spec.find_cell(spec.load_benchmark(ROOT), ROOT, CELL)
    table = traffic.length_table(c.traffic["lengths"])
    assert table == [3500, 4482, 5342, 6103, 6829, 7553, 8299, 9085, 9934, 10875, 11948, 13216,
                     14789, 16894, 20137, 27469]
    assert sum(table) == 176455


def test_the_draw_holds_the_ports_leaves():
    c = _cell()
    m = _port(c)
    sz = hybrid.sizes_of(c.config)
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == hybrid.expected_shapes(sz)
    again = hybrid.draw(sz, 7, 2, "cpu")
    for n, t in again.items():
        assert torch.equal(dict(m.named_parameters())[n], t), n
    full = spec.find_cell(spec.load_benchmark(ROOT), ROOT, CELL).config
    shapes = hybrid.expected_shapes(hybrid.sizes_of(full))
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 32_207_337_984


def test_launches_and_operations_are_the_ports():
    """One forward's port-operator calls (the profiler's ``repro_torch::``
    ops, as the trace's pass B counts them) and its GEMM operations
    (``FlopCounterMode`` plus the grouped products, which it does not
    count) against ``flops.hybrid``."""
    from repro_torch.obs.registry import MetricsRegistry, recording
    c = _cell()
    m = _port(c)
    sz = hybrid.sizes_of(c.config)
    S = 48
    tokens = torch.randint(0, sz.vocab, (1, S))
    reg = MetricsRegistry()
    with torch.no_grad(), recording(reg), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m(tokens, logits_positions="last")
    calls = Counter(trace.kernel_of_op(e.key) for e in prof.events()
                    if e.key.startswith(trace.PORT_OP))
    counters = reg.to_dict()["counters"]
    hits = counters["host.moe.experts_hit"] / sz.num_layers
    want = work_hybrid.forward(sz, 1, S, last_only=True, hits=hits)
    assert {k: v for k, v in want.launches().items() if v} == dict(calls)
    assert want.launches()["rmsnorm"] == 3 * 3 + 2 * 1 + 1
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        m(tokens, logits_positions="last")
    grouped = sz.num_layers * 3 * 2 * S * sz.top_k * sz.d_model * sz.d_ff_expert
    assert fc.get_total_flops() + grouped == model.flops(want, model.MODEL_KINDS)


def test_the_bound_of_a_grouped_product_is_one_launchs():
    """h equal shares of R rows bound like one launch of R rows and h
    experts' weights."""
    from portbench.flops.peaks import bound_s
    sz = hybrid.sizes_of(spec.find_cell(spec.load_benchmark(ROOT), ROOT, CELL).config)
    T, hits = 3500, 72
    gemm = work_hybrid.moe(sz, T, hits)
    routed = gemm[1:1 + 3 * hits]
    w = model.Work(gemm=routed)
    R, H, F = T * sz.top_k, sz.d_model, sz.d_ff_expert
    one = sum(bound_s(2 * R * H * F, (R * a + hits * H * F + R * b) * 2)
              for a, b in ((H, F), (H, F), (F, H)))
    assert abs(model.bound(w, ("gemm",)) - one) < 1e-12 * one


def test_the_driver_end_to_end_on_the_cpu():
    """Set-up, a window of one cycle and the check, fp32 throughout: the
    served logits are the reference's; at fp8 the reference's are not."""
    from portbench.reference.common import LowP
    c = _cell()
    d = spec.mode_module(c.traffic).Driver(c, 2 ** 33 + 5, "cpu")
    d.setup()
    res = d.window(1e-9)
    assert res["attempted"] == 3 and res["metrics"]["prefill_tokens_per_s"] > 0
    d.release()
    numbers = d.check()
    assert set(numbers) == set(c.limits)
    assert max(numbers.values()) < 1e-5
    assert d.check(LowP())["logit_err"] > 1e-2


def test_the_moe_span_splits_into_its_gemms_and_the_rest():
    """``prefill_hybrid.split_by_span``: a GEMM and an elementwise kernel
    launched inside ``host.layer.moe`` and a GEMM outside it; the GEMM
    split holds the MoE's GEMM alone."""
    from portbench import trace
    from portbench.modes.prefill_hybrid import split_by_span
    from test_portbench_spans import Ev
    events = [Ev(trace.WINDOW, 0, 1000), Ev("host.serve.prefill", 10, 900),
              Ev("host.layer.moe", 100, 300),
              Ev("cudaLaunchKernel", 50, 51, corr=1), Ev("cudaLaunchKernel", 150, 151, corr=2),
              Ev("cudaLaunchKernel", 250, 251, corr=3),
              Ev("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", 5000, 5100, corr=1, cuda=True),
              Ev("cutlass_80_wmma_tensorop_bf16_s161616gemm_grouped", 5100, 5400, corr=2,
                 cuda=True),
              Ev("void at::native::vectorized_elementwise_kernel<4>", 5400, 5450, corr=3,
                 cuda=True)]
    by_span, gemms = split_by_span(events)
    assert by_span == {"host.serve.prefill": 100, "host.layer.moe": 350}
    assert gemms == {"host.serve.prefill": 100, "host.layer.moe": 300}
