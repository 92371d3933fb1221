"""The program's spans on made-up profiler timelines (``portbench.spans``),
the passes of ``portbench.trace`` with and without the program's span
records in them, and the update's least bytes against the port's leaves."""

import json

import pytest
import torch

from portbench import spans, spec, trace
from portbench.flops import model
from portbench.flops.update import update_bytes
from portbench.sizes import sizes_of
from portbench.weights import expected_shapes
from portbench_tiny import ROOT, cell

MAIN, AUTOGRAD = 1, 2
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A stand-in for one of the profiler's kineto events."""

    def __init__(self, name, start, end, tid=MAIN, corr=0, cuda=False, annotation=False):
        self._n, self._s, self._e, self._t, self._c = name, start, end, tid, corr
        self._d, self._a = (CUDA if cuda else CPU), annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_innermost_takes_the_deepest_open_interval():
    ivs = [("outer", 0, 100), ("inner", 20, 40), ("late", 60, 90)]
    assert spans.innermost([95, 30, 5, 70, 200, 40], ivs) == \
        ["outer", "inner", "outer", "late", None, "inner"]
    assert spans.innermost([1], []) == [None]


def test_a_kernel_launched_by_autograd_inside_the_backward_is_the_backwards():
    """The main thread waits inside host.train.backward while autograd's
    device thread launches the backward's kernels: their device time, and
    the gap each ends, go to the span; the gap's host op is the launching
    thread's."""
    events = [
        Ev(trace.WINDOW, 0, 1000),
        Ev("host.train.forward", 10, 100),
        Ev("aten::mm", 20, 40), Ev("cudaLaunchKernel", 30, 32, corr=1),
        Ev("host.train.backward", 200, 900),
        Ev("autograd::engine::evaluate_function: MmBackward0", 300, 420, tid=AUTOGRAD),
        Ev("cudaLaunchKernel", 400, 402, tid=AUTOGRAD, corr=2),
        Ev("cudaLaunchKernel", 600, 602, tid=AUTOGRAD, corr=3),
        Ev("host.train.apply_optimizer", 920, 990),
        Ev("cudaLaunchKernel", 950, 951, corr=4),
        # device: the forward's kernel, two of the backward's, one of the update's
        Ev("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", 5000, 5100, corr=1, cuda=True),
        Ev("nvjet_tst_288x128_64x3_1x2_h_bz_coopA_NTN", 5160, 5300, corr=2, cuda=True),
        Ev("void at::native::vectorized_elementwise_kernel<4>", 5500, 5550, corr=3, cuda=True),
        Ev("host.train.backward", 5150, 5560, cuda=True, annotation=True),
        Ev("void at::native::vectorized_elementwise_kernel<4>", 5560, 5600, corr=4, cuda=True),
    ]
    found = spans.reduce(events)
    assert found["device_by_span"] == {"host.train.forward": 100, "host.train.backward": 190,
                                       "host.train.apply_optimizer": 40}
    assert found["device_ops"] == 4
    # gaps: 60 ns ending at launch 2 (host 340-400, autograd inside MmBackward0),
    # 200 ns ending at launch 3 (host 400-600, autograd between ops), 10 ns
    # ending at launch 4 (host 941-951, the main thread inside the update)
    assert found["idle_by_span"] == {
        "host.train.backward / autograd::engine::evaluate_function: MmBackward0": 60,
        "host.train.backward / host between ops": 200,
        "host.train.apply_optimizer / host between ops": 10}
    assert found["idle_ns"] == 270


def test_gaps_outside_every_span_say_so():
    events = [Ev(trace.WINDOW, 0, 1000), Ev("aten::add", 100, 300),
              Ev("cudaLaunchKernel", 150, 151, corr=1), Ev("cudaLaunchKernel", 700, 701, corr=2),
              Ev("k", 10, 20, corr=1, cuda=True), Ev("k", 520, 530, corr=2, cuda=True)]
    found = spans.reduce(events)
    assert found["idle_by_span"] == {"outside spans / host between ops": 500}
    assert found["device_by_span"] == {"outside spans": 20}


def test_program_span_records_are_not_device_ops():
    events = [Ev("host.train.backward", 0, 50, cuda=True, annotation=True),
              Ev("host.serve.prefill", 0, 50, cuda=True, annotation=True),
              Ev(trace.STEP, 0, 60, cuda=True),
              Ev("repro_torch::rmsnorm", 0, 60, cuda=True),
              Ev("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", 5, 9, corr=7, cuda=True),
              Ev("host.train.forward", 0, 50)]
    assert trace._device_events(events) == [("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", 5, 9, 7)]


def test_a_short_span_count_raises():
    counters = {"host.train.forward.calls": 16, "host.train.backward.calls": 15}
    spans.check_span_calls(counters, {"host.train.forward": 16})
    with pytest.raises(trace.TraceError, match="host.train.backward: 15 calls"):
        spans.check_span_calls(counters, {"host.train.forward": 16, "host.train.backward": 16})
    with pytest.raises(trace.TraceError):
        spans.check_span_calls({}, {"host.serve.prefill": 1})


# -- the twelve readers, with and without the program's spans in the passes --

RMS = "void repro_torch::(anonymous namespace)::rmsnorm_rows_kernel<16>(__nv_bfloat16 const*)"
SSD = "void repro_torch::(anonymous namespace)::ssd_chunk_scan_kernel<128>(CUtensorMap_st)"
FLASH = "void repro_torch::(anonymous namespace)::flash_wgmma_kernel<128>(CUtensorMap_st)"
GEMM = "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT"
ADD = "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>>"


def _timeline(with_spans: bool, cpu: bool):
    """One step's events: a GEMM, an RMSNorm, an SSD scan and a flash
    forward inside their operators, and an eager add; with the program's
    spans around them (and their images on the device timeline)."""
    host = [Ev(trace.WINDOW, 0, 10_000), Ev(trace.STEP, 5, 9_995),
            Ev("aten::mm", 100, 200), Ev("cudaLaunchKernel", 150, 152, corr=1),
            Ev("repro_torch::rmsnorm", 300, 400), Ev("cudaLaunchKernel", 350, 352, corr=2),
            Ev("repro_torch::ssd_scan", 500, 600), Ev("cudaLaunchKernel", 550, 552, corr=3),
            Ev("repro_torch::flash_attention_fwd", 700, 800),
            Ev("cudaLaunchKernel", 750, 752, corr=4),
            Ev("aten::add", 2000, 2100, tid=AUTOGRAD),
            Ev("cudaLaunchKernel", 2050, 2052, tid=AUTOGRAD, corr=5)]
    device = [Ev(GEMM, 20_000, 20_400, corr=1, cuda=True), Ev(RMS, 20_500, 20_560, corr=2, cuda=True),
              Ev(SSD, 20_600, 21_000, corr=3, cuda=True), Ev(FLASH, 21_000, 21_300, corr=4, cuda=True),
              Ev(ADD, 23_000, 23_100, corr=5, cuda=True)]
    if with_spans:
        host += [Ev("host.train.forward", 50, 900), Ev("host.train.backward", 1000, 3000)]
        device += [Ev("host.train.forward", 20_000, 21_300, cuda=True, annotation=True),
                   Ev("host.train.backward", 22_000, 23_100, cuda=True, annotation=True)]
    return (host if cpu else []) + device


def _capture(monkeypatch, with_spans: bool):
    from torch.profiler import ProfilerActivity
    launches = model.Work(gemm=[(64, 32, 48)], rmsnorm=[(64, 32)], ssd_scan=[(1, 2, 64, 4, 2)],
                          flash_attention=[(1, 2, 1, 4, 8, True, 0)])
    counted = {"rmsnorm": 1, "ssd_scan": 1, "flash_attention": 1}

    def run():
        return {"steps": 1, "requests": 1, "tokens": 64, "launches": launches,
                "window_ns": (0, 10_000)}

    def fake_profile(run, counts, activities):
        return _timeline(with_spans, ProfilerActivity.CPU in activities), run(), dict(counted)
    monkeypatch.setattr(trace, "_profile", fake_profile)
    return trace.capture(run, lambda: {}, launches.launches())


def test_the_twelve_readers_read_the_same_with_program_spans(monkeypatch):
    names = [m["name"] for m in spec.load_benchmark(ROOT)["per_layer"]]
    assert len(names) >= 12
    read = {}
    for with_spans in (False, True):
        tr = _capture(monkeypatch, with_spans)
        read[with_spans] = {n: spec.metric_reader(n)(tr) for n in names}
        read[with_spans]["busy_s"], read[with_spans]["window_s"] = tr.busy_s, tr.window_s
    assert json.dumps(read[True], sort_keys=True) == json.dumps(read[False], sort_keys=True)
    assert read[True]["gemm_roofline.train"] is not None
    assert read[True]["flash_attention_roofline.serve"] is not None


# -- the update's least bytes --------------------------------------------------

FP32_BF16 = {"masters": "float32", "grads": "float32", "moments": "float32", "compute": "bfloat16"}


def test_update_bytes_count_the_ports_leaves():
    from repro_torch.models.lm import LM, RunCfg
    from portbench.spec import arch_of
    c = cell("mamba2-train-2k")
    sz = sizes_of(c.config)
    m = LM(arch_of(c.config), RunCfg(compute_dtype=torch.bfloat16, remat=False), "cpu")
    leaves = [p.numel() for p in m.parameters()]
    shapes = [torch.Size(s).numel() for s in expected_shapes(sz).values()]
    assert update_bytes(leaves, FP32_BF16) == update_bytes(shapes, FP32_BF16) == 30 * sum(leaves)
    assert update_bytes([10], {**FP32_BF16, "moments": "bfloat16"}) == 10 * (4 + 4 + 4 * 2 + 4 + 2)


def test_update_bytes_of_the_train_cell():
    c = spec.find_cell(spec.load_benchmark(ROOT), ROOT, "mamba2-train-2k")
    params = sum(torch.Size(s).numel() for s in expected_shapes(sizes_of(c.config)).values())
    assert 2.80e9 < params < 2.86e9                 # the untied head included
    assert update_bytes([params], FP32_BF16) == pytest.approx(84.9e9, rel=2e-3)
