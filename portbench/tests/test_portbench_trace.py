"""The trace's reductions on made-up timelines, and the groups of the
kernel names the port's cells run on the card."""

import pytest

from portbench import groups, trace


def test_busy_is_the_union_of_the_ops():
    ops = [("a", "g", 0, 10), ("b", "g", 5, 20), ("c", "g", 30, 40), ("d", "g", 95, 120)]
    assert trace.busy_intervals(ops) == [(0, 20), (30, 40), (95, 120)]
    tr = trace.Trace(window_ns=(2, 100), ops=ops)
    assert tr.busy_s == pytest.approx((20 + 10 + 25) / 1e9)
    assert tr.time_s(lambda g: True) == pytest.approx((10 + 15 + 10 + 25) / 1e9)


def test_idle_divides_busy_by_the_unprofiled_window():
    from portbench.metrics.common import idle_pct
    tr = trace.Trace(window_ns=(0, 200), ops=[("a", "g", 0, 60), ("b", "g", 100, 130)],
                     work={"plain_window_s": 120e-9})
    assert idle_pct(tr) == pytest.approx(100.0 * (1 - 90 / 120))
    tr.work["plain_window_s"] = 0.0
    assert idle_pct(tr) is None


def test_idle_goes_to_the_innermost_host_op():
    gaps = [(60, 100), (0, 10), (20, 50)]
    host = [("outer", 0, 100), ("inner", 25, 45), ("late", 70, 90)]
    out = trace.idle_by_host(gaps, host)
    # mids: 5 -> outer, 35 -> inner, 80 -> late
    assert out == {"outer": 10, "inner": 30, "late": 40}
    assert trace.idle_by_host([(0, 10)], []) == {"host between ops": 10}


def test_a_device_gap_ends_at_the_launch_that_ends_it():
    # device clock: ops at [0,10], [15,40] (launched at host 1000), [30,50],
    # [70,80] (launched at host 2000): gaps of 5 and 20
    device = [("a", 0, 10, 1), ("b", 15, 40, 2), ("c", 30, 50, 3), ("d", 70, 80, 4)]
    launch = {1: 900, 2: 1000, 3: 1010, 4: 2000}
    assert trace.device_gaps(device, launch) == [(995, 1000), (1980, 2000)]


def test_a_pass_that_lost_records_runs_again():
    tries = []

    def lossy():
        tries.append(1)
        if len(tries) < 3:
            raise trace.RecordsLost("lost")
        return "whole"
    assert trace._attempts(lossy) == "whole" and len(tries) == 3

    def wrong():
        tries.append(1)
        raise trace.TraceError("misattributed")
    tries.clear()
    with pytest.raises(trace.TraceError):
        trace._attempts(wrong)
    assert len(tries) == 1

    def always_lost():
        raise trace.RecordsLost("lost")
    with pytest.raises(trace.RecordsLost):
        trace._attempts(always_lost)


@pytest.mark.parametrize("name,kernel", [
    ("void repro_torch::(anonymous namespace)::ssd_bwd_chunk_kernel<128>(CUtensorMap_st)", "ssd_scan_bwd"),
    ("repro_torch::(anonymous namespace)::ssd_bwd_sums(repro_torch::BwdParams, int)", "ssd_scan_bwd"),
    ("void repro_torch::(anonymous namespace)::ssd_cb_kernel<128, true>(CUtensorMap_st)", "ssd_scan_bwd"),
    ("void repro_torch::(anonymous namespace)::ssd_cb_kernel<128, false>(CUtensorMap_st)", "ssd_scan"),
    ("void repro_torch::(anonymous namespace)::ssd_chunk_scan_kernel<128>(CUtensorMap_st)", "ssd_scan"),
    ("void repro_torch::(anonymous namespace)::flash_wgmma_kernel<128>(CUtensorMap_st)", "flash_attention"),
    ("void repro_torch::(anonymous namespace)::rmsnorm_rows_kernel<16>(__nv_bfloat16 const*)", "rmsnorm"),
    ("void repro_torch::(anonymous namespace)::rmsnorm_bwd_rows_kernel<2560, 4>(__nv_bfloat16)", "rmsnorm_bwd"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT", None),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>>", None),
    ("Memcpy DtoD (Device -> Device)", None),
])
def test_groups_of_the_cells_kernels(name, kernel):
    label = groups.group(name)
    assert groups.port_kernel(label) == kernel
    if name.startswith("nvjet"):
        assert groups.layer(label) == "gemm"
    elif kernel is None:
        assert groups.layer(label) == "eager"


def test_operator_names_map_to_counters():
    assert trace.kernel_of_op("repro_torch::flash_attention_fwd") == "flash_attention"
    assert trace.kernel_of_op("repro_torch::ssd_scan_bwd") == "ssd_scan_bwd"
    assert trace.kernel_of_op("repro_torch::rmsnorm") == "rmsnorm"
