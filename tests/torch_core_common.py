"""Helpers shared by the simulator core's tests (tests/test_torch_core.py,
tests/test_torch_fastbatch.py); pytest does not collect this file."""

import dataclasses


def assert_same_result(a, b, ctx=None):
    """Every SimResult field that the two packages can hold equal, exactly,
    and the raw trace bytes."""
    for f in ("total_time", "throughput", "bubble_ratio", "noc_bytes", "dram_bytes",
              "event_count", "recompute", "engine"):
        assert getattr(a, f) == getattr(b, f), (ctx, f, getattr(a, f), getattr(b, f))
    assert [dataclasses.asdict(m) for m in a.stage_memory] == \
        [dataclasses.asdict(m) for m in b.stage_memory], ctx
    assert a.trace.to_bytes() == b.trace.to_bytes(), ctx
