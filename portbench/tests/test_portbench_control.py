"""The control, the reference at fp8 in the port's place, comes out not
correct under each cell's limits, here at tiny widths on the CPU; on the
card it is read at the cell's own size by ``portbench/control.py``."""

import pytest

from portbench import spec
from portbench.reference.common import LowP
from portbench_tiny import cell


@pytest.mark.parametrize("name", ["mamba2-train-2k", "yi6b-prefill-docqa"])
def test_control_fails_a_limit(name):
    c = cell(name)
    driver = spec.mode_module(c.traffic).Driver(c, 2 ** 31 + 5, "cpu")
    driver.setup()
    driver.window(0.5)
    driver.release()
    numbers = driver.check(LowP())
    assert any(numbers[k] > v for k, v in c.limits.items()), numbers
