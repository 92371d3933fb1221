"""The port's training path against the reference on the CPU, tiny
granite-moe-3b-a800m (4 experts, top-2). The tests and their tolerances
are in tests/torch_train_common.py.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_train_common import (  # noqa: E402,F401
    build_setup, one_torch_thread, test_loss_and_grads_match_jax_fp32,
    test_loss_and_grads_match_jax_bf16, test_remat_gives_the_same_grads,
    test_eval_step_matches_loss_fn, test_train_step_g2_matches_jax,
    test_jax_checkpoint_restores_into_the_port, test_port_checkpoint_restores_into_jax,
    test_bf16_moments_do_not_checkpoint,
    test_jax_bf16_checkpoint_restores_into_the_port_bit_exactly,
    test_port_bf16_checkpoint_writes_the_reference_bytes, test_port_round_trips_bf16_moments,
    test_train_loop_loss_decreases, test_train_restart_resumes_deterministically,
    test_scaled_down_arch_is_the_reference_one, test_main_runs_on_the_cpu)


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m"])
def setup(request):
    return build_setup(request.param)


@pytest.fixture(params=["granite-moe-3b-a800m"])
def name(request):
    return request.param
