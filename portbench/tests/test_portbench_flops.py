"""Operations and bytes agree with hand counts at small shapes, and the
launches worked out from shapes with what the port runs."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights
from portbench.flops import kernels, model, peaks
from portbench.sizes import sizes_of
from portbench_tiny import cell


def test_hand_counts():
    assert kernels.gemm(2, 3, 4) == (48, (6 + 12 + 8) * 2, peaks.BF16_FLOPS)
    # 4 queries, causal: 1 + 2 + 3 + 4 = 10 pairs; q k^T and p v at 2 hd each
    assert kernels.attention_pairs(4) == 10 and kernels.attention_pairs(4, window=2) == 3 + 2 + 2
    assert kernels.attention_pairs(4, causal=False) == 16
    f, b, _ = kernels.flash_fwd(1, 2, 1, 4, 8)
    assert f == 4 * 2 * 8 * 10 and b == (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8) * 2
    f, b, _ = kernels.flash_bwd(1, 2, 1, 4, 8)
    assert f == 10 * 2 * 8 * 10 and b == (4 * 2 * 4 * 8 + 4 * 1 * 4 * 8) * 2
    # one 64-token chunk, 2 heads of 4, N 2
    f, b, _ = kernels.ssd_fwd(1, 2, 64, 4, 2)
    assert f == 64 * (2 * 64 * 2 + 2 * (2 * 64 * 4 + 4 * 4 * 2))
    assert b == 2 * 2 * 64 * 4 * 2 + 2 * 64 * 4 + 2 * 4 + 2 * 64 * 2 * 2
    f, b, _ = kernels.ssd_bwd(1, 2, 64, 4, 2)
    pairs = 64 * 65 // 2
    assert f == pairs * 2 * 2 + 2 * (pairs * 2 * (8 + 4) + 64 * 5 * 2 * 4 * 2)
    assert kernels.rmsnorm_fwd(3, 5) == (60, (30 + 5) * 2, peaks.FP32_FLOPS)
    assert kernels.rmsnorm_bwd(3, 5) == (150, (45 + 5) * 2, peaks.FP32_FLOPS)
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_counts_match_the_ports_formulas():
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    assert kernels.flash_fwd(2, 8, 2, 300, 64)[0] == fa.flops(2, 8, 300, 64)
    assert kernels.flash_bwd(2, 8, 2, 300, 64)[0] == fa.bwd_flops(2, 8, 300, 64)
    assert kernels.ssd_fwd(2, 8, 300, 64, 16)[0] == ss.fwd_flops(2, 8, 300, 64, 16)
    assert kernels.ssd_bwd(2, 8, 300, 64, 16)[0] == ss.bwd_flops(2, 8, 300, 64, 16)


def _port(name):
    from repro_torch.models.lm import LM, RunCfg
    from portbench.spec import arch_of
    c = cell(name, compute="float32")
    sz = sizes_of(c.config)
    m = LM(arch_of(c.config), RunCfg(compute_dtype=torch.float32, remat=False), "cpu")
    weights.load_into(dict(m.named_parameters()), sz, 5)
    return m, sz


@pytest.mark.parametrize("name", ["mamba2-train-2k", "yi6b-prefill-docqa"])
def test_forward_and_step_flops_match_flop_counter(name):
    """FlopCounterMode over the port's forward (and backward) on the CPU
    counts the GEMMs and the kernels' registered formulas."""
    from repro_torch.models.lm import loss_fn
    m, sz = _port(name)
    S = 48
    tokens = torch.randint(0, sz.vocab, (1, S))
    with FlopCounterMode(display=False) as fc:
        m(tokens, logits_positions="last")
    want = model.forward(sz, 1, S, last_only=True)
    assert fc.get_total_flops() == model.flops(want, model.MODEL_KINDS)
    with FlopCounterMode(display=False) as fc:
        loss, _ = loss_fn(m, {"tokens": tokens, "labels": tokens})
        loss.backward()
    step = model.train_step(sz, 1, 1, S)
    assert fc.get_total_flops() == model.flops(step, model.MODEL_KINDS)


def test_launch_kinds_follow_the_model():
    m, sz = _port("mamba2-train-2k")
    w = model.train_step(sz, 8, 1, 2048)
    L = sz.num_layers
    assert w.launches() == {"rmsnorm": 8 * (2 * L + 1), "rmsnorm_bwd": 8 * (2 * L + 1),
                            "ssd_scan": 8 * L, "ssd_scan_bwd": 8 * L, "flash_attention": 0,
                            "flash_attention_bwd": 0}
    assert len(w.gemm) == 8 * 3 * (2 * L + 1)
