"""granite-4.0-h-small at tiny widths on the CPU against the benchmark's
plain reference (``portbench/reference/granite_h.py``, plain fp32 PyTorch
that imports nothing of the port and no JAX): Mamba-2 and NoPE attention
layers by ``layer_types``, each followed by a dropless MoE with a shared
expert; the embedding, residual and logit multipliers; the tied head.
The weights are the benchmark's draw (``portbench.hybrid``)."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import hybrid  # noqa: E402
from portbench.reference import common, granite_h  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import moe, moe_dropless  # noqa: E402
from repro_torch.models.lm import LM, RunCfg  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry, recording  # noqa: E402

TYPES = ("mamba", "mamba", "attention", "mamba")
ARCH = dataclasses.replace(get_config("granite-4.0-h-small"), num_layers=4, d_model=64, n_heads=4,
                           n_kv=2, head_dim=16, vocab=256, n_experts=8, top_k=2, d_ff_expert=32,
                           d_ff_shared=32, ssm_state=16, ssm_headdim=16, d_inner=128,
                           attn_scale=0.03, layer_types=TYPES)
SZ = hybrid.HybridSizes(**{f.name: getattr(ARCH, f.name)
                           for f in dataclasses.fields(hybrid.HybridSizes)})
SEED = 2147483648 + 17


def _port(dtype=torch.float32) -> LM:
    m = LM(ARCH, RunCfg(compute_dtype=dtype, remat=False), "cpu")
    hybrid.load_into(dict(m.named_parameters()), SZ, SEED)
    return m


def _prompts():
    g = torch.Generator().manual_seed(3)
    return [torch.randint(0, SZ.vocab, (S,), generator=g) for S in (9, 70)]


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.detach().float() - b) / torch.linalg.vector_norm(b))


def test_the_draw_is_the_ports_leaves():
    m = LM(ARCH, RunCfg(compute_dtype=torch.float32), "meta")
    hybrid.check_leaves(dict(m.named_parameters()), SZ)
    assert not hasattr(m, "lm_head")


def test_fp32_logits_match_the_reference():
    m, prompts = _port(), _prompts()
    ref = granite_h.last_logits(SZ, SEED, prompts, "cpu", served=None)
    for p, r in zip(prompts, ref):
        assert _rel(m(p[None], logits_positions="last")[0, -1], r) < 1e-4


def test_bf16_logits_within_the_moe_rule():
    """ROADMAP §3's rule for MoE: the port's bf16 logits sit no further
    from the fp32 reference than 1.25x the reference's own bf16 does (the
    same code on the bf16 weights, computing in bf16)."""
    m, prompts = _port(torch.bfloat16), _prompts()
    ref = granite_h.last_logits(SZ, SEED, prompts, "cpu")
    own = granite_h.last_logits(SZ, SEED, prompts, "cpu", compute=torch.bfloat16)
    for p, r, o in zip(prompts, ref, own):
        got = m(p[None], logits_positions="last")[0, -1]
        assert _rel(got, r) <= 1.25 * _rel(o, r)


def test_decode_through_the_mixed_cache_matches_the_forward():
    """Token by token through ``decode_step``: k, v held for the one
    attention layer, conv and SSM state for the three Mamba layers."""
    m = _port()
    tokens = torch.stack([p[:9] for p in _prompts()])
    cache = m.init_cache(2, 9)
    assert {n: t.shape[0] for n, t in cache.items()} == {"k": 1, "v": 1, "conv": 3, "ssm": 3}
    with torch.no_grad():
        full = m(tokens)
        for i in range(9):
            torch.testing.assert_close(m.decode_step(cache, tokens[:, i], i), full[:, i],
                                       rtol=1e-4, atol=1e-5)


def _ref_loss(P, tokens, labels):
    """The reference's mean next-token loss of one row under the fp32
    leaves ``P`` (full names), with autograd."""
    x = [P["embed"][tokens] * SZ.embed_scale]
    for i, kind in enumerate(TYPES):
        pre = f"blocks.{i}."
        x = granite_h.layer(x, {n[len(pre):]: t for n, t in P.items() if n.startswith(pre)},
                            kind, SZ)
    logits = common.rmsnorm(x[0], P["final_norm"]) @ P["embed"].t() / SZ.logit_scale
    return torch.nn.functional.cross_entropy(logits, labels)


def test_train_step_loss_and_gradients_fp32():
    """Loss and every gradient, the tied embedding's (from the input and
    the head) included, against autograd of the reference; then one train
    step moves every master."""
    from repro_torch.train.optim import OptimizerCfg, init_opt_state
    from repro_torch.train.step import TrainCfg, TrainState, accumulate_grads, make_train_step
    m = _port()
    row = _prompts()[1]
    batch = {"tokens": row[None, None, :-1], "labels": row[None, None, 1:]}
    cfg = TrainCfg(run=m.cfg)
    grads, loss, _ = accumulate_grads(m, batch, cfg)
    P = {n: t.detach().clone().requires_grad_(True) for n, t in m.named_parameters()}
    ref = _ref_loss(P, row[:-1], row[1:])
    ref.backward()
    ref = float(ref.detach())
    assert abs(float(loss) - ref) < 1e-5 * ref
    for n, t in P.items():
        assert _rel(grads[n], t.grad) < 1e-4, n
    params = {n: t.detach().clone() for n, t in m.named_parameters()}
    state = TrainState(m, params, init_opt_state(OptimizerCfg(), params))
    before = {n: t.clone() for n, t in params.items()}
    _, metrics = make_train_step(ARCH, cfg)(state, batch)
    assert abs(float(metrics["loss"]) - ref) < 1e-5 * ref
    assert all(not torch.equal(state.params[n], before[n]) for n in before if "norm" not in n)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 0.0)])
def test_dropless_equals_capacity_where_nothing_drops(dtype, tol):
    """At capacity E/k every expert has a slot for every token, so the
    capacity layer drops nothing and gives the dropless layer's answer
    (bf16: bit for bit, one rounding of the same products each way)."""
    g = torch.Generator().manual_seed(5)
    T, H, E, k, F = 37, 64, 8, 2, 32
    x = torch.randn(T, H, generator=g).to(dtype)
    params = {"router": torch.randn(H, E, generator=g).to(dtype),
              "wg": (torch.randn(E, H, F, generator=g) * H ** -0.5).to(dtype),
              "wi": (torch.randn(E, H, F, generator=g) * H ** -0.5).to(dtype),
              "wo": (torch.randn(E, F, H, generator=g) * F ** -0.5).to(dtype)}
    want, aux_c = moe(x, params, k, capacity_factor=E / k)
    got, aux_d = moe_dropless(x, params, k)
    assert abs(float(aux_c["drop_fraction"])) < 1e-6
    assert torch.equal(aux_c["load"], aux_d["load"]) and int(aux_d["load"].sum()) == T * k
    assert _rel(got, want.float()) <= tol


def test_the_spans_and_counters_of_a_prefill():
    m, p = _port(), _prompts()[1]
    reg = MetricsRegistry()
    with recording(reg), torch.no_grad():
        m(p[None], logits_positions="last")
    c = reg.to_dict()["counters"]
    assert c["host.layer.moe.calls"] == 4
    assert {k.rsplit(".", 1)[0] for k in c if k.startswith("host.layer.")} == {"host.layer.moe"}
    assert c["host.moe.assignments"] == 4 * len(p) * ARCH.top_k
    assert 4 <= c["host.moe.experts_hit"] <= 4 * ARCH.n_experts
    with torch.no_grad():
        m(p[None], logits_positions="last")          # no registry: nothing counted
    assert reg.to_dict()["counters"] == c


def test_one_device_only():
    with pytest.raises(NotImplementedError, match="one device"):
        from repro_torch.models.lm import _check_supported
        _check_supported(ARCH, mesh=object())


def test_the_published_arch():
    a = get_config("granite-4.0-h-small")
    assert a.layer_blocks.count("attn") == 4 and a.layer_blocks[5] == "attn"
    assert round(a.param_count() / 1e9, 2) == 32.21
    assert a.has_attention and a.has_ssm and not a.subquadratic
