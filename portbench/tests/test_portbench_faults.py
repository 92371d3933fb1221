"""A run's check at tiny widths on the CPU: sound runs come out correct,
and a run with its timed path broken underneath comes out not correct,
once for each fault the cell can have. The look for a card is skipped;
the rest of a run (set-up, window, release, check, judge) is driven as
``run.py`` drives it, with the cell's own limits. The port computes in
fp32 here, so only the fault can move the numbers."""

from pathlib import Path

import pytest

from portbench import faults, spec
from portbench_tiny import cell

ROOT = Path(__file__).resolve().parents[2]
run = spec.load_module(ROOT / "portbench" / "run.py", "portbench_run_for_tests")


def _correct(name, fault=None, seed=2 ** 31 + 11):
    c = cell(name, compute="float32")
    driver = spec.mode_module(c.traffic).Driver(c, seed, "cpu")
    if fault is None:
        driver.setup()
    else:
        with faults.FAULTS[fault]():
            driver.setup()
    res = driver.window(0.5)
    driver.release()
    ok, checks = run.judge(driver.check(), c.limits, res["failed"])
    return ok, checks


@pytest.mark.parametrize("name", ["mamba2-train-2k", "yi6b-prefill-docqa"])
def test_sound_runs_are_correct(name):
    ok, checks = _correct(name)
    assert ok, checks


@pytest.mark.parametrize("name,fault", [("mamba2-train-2k", "unchanged"),
                                        ("mamba2-train-2k", "half_batch"),
                                        ("mamba2-train-2k", "stale_copy"),
                                        ("mamba2-train-2k", "wrong_v"),
                                        ("yi6b-prefill-docqa", "altered_token")])
def test_a_fault_is_not_correct(name, fault):
    ok, checks = _correct(name, fault)
    assert not ok, checks

