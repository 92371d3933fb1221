"""The plain reference agrees with the port at tiny widths on the CPU,
both in fp32: the prefill's last logits, one row's loss and gradients,
and Adam's update. (This test imports both; the reference imports nothing
of the port.)"""

import torch

from portbench import traffic, weights
from portbench.reference import lm as ref_lm, train as ref_train
from portbench.sizes import block_sizes, sizes_of
from portbench.spec import arch_of
from portbench_tiny import cell


def _port(c, seed):
    from repro_torch.models.lm import LM, RunCfg
    m = LM(arch_of(c.config), RunCfg(compute_dtype=torch.float32, remat=False), "cpu")
    weights.load_into(dict(m.named_parameters()), sizes_of(c.config), seed)
    return m


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_prefill_logits():
    c = cell("yi6b-prefill-docqa")
    sz = sizes_of(c.config)
    m = _port(c, 11)
    prompts = [traffic.prompt(sz.vocab, L, 11, 0, i, "cpu")[0] for i, L in enumerate((7, 40))]
    ref = ref_lm.last_logits(sz, block_sizes(c.config, sz), 11, prompts, "cpu", served=None)
    for p, r in zip(prompts, ref):
        got = m(p[None], logits_positions="last")[0, -1]
        assert _rel(got, r) < 1e-5


def test_loss_gradients_and_adam():
    from repro_torch.models.lm import loss_fn
    from repro_torch.train.optim import OptimizerCfg, apply_optimizer, init_opt_state
    c = cell("mamba2-train-2k")
    sz = sizes_of(c.config)
    m = _port(c, 12)
    batch = traffic.train_batch(c.traffic, sz.vocab, 12, 1, "cpu")
    tokens, labels = batch["tokens"][0], batch["labels"][0]
    loss, _ = loss_fn(m, {"tokens": tokens, "labels": labels})
    loss.backward()
    P = weights.masters(sz, 12, "cpu")
    grads = {n: torch.zeros_like(p) for n, p in P.items()}
    ref_loss = ref_lm.fwd_bwd(P, sz, block_sizes(c.config, sz), tokens[0], labels[0], grads)
    assert abs(float(loss) - ref_loss) < 1e-5 * ref_loss
    for n, p in m.named_parameters():
        assert _rel(p.grad, grads[n]) < 1e-4, n
    o = c.traffic["optimizer"]
    opt = OptimizerCfg(**{k: o[k] for k in ("peak_lr", "warmup_steps", "decay_steps", "min_lr_ratio",
                                            "b1", "b2", "eps", "weight_decay", "grad_clip")})
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    state = init_opt_state(opt, params)
    for t in (1, 2):
        apply_optimizer(opt, params, grads, state)
        if t == 1:
            mv = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in P.items()}
        ref_train.adam(o, t, P, grads, {n: a for n, (a, _) in mv.items()},
                       {n: b for n, (_, b) in mv.items()})
    for n in params:
        assert torch.allclose(params[n], P[n], rtol=1e-6, atol=1e-9), n


def test_ssd_matches_the_ports_plain_scan():
    from repro_torch.kernels.ref import ssd_scan_ref
    from portbench.reference.ssd import ssd
    g = torch.Generator().manual_seed(3)
    b, S, h, p, n = 1, 100, 3, 8, 4
    x = torch.randn(b, S, h, p, generator=g)
    dt = torch.rand(b, S, h, generator=g) * 0.1
    A = -torch.rand(h, generator=g) * 4
    B, C = torch.randn(b, S, n, generator=g), torch.randn(b, S, n, generator=g)
    got = ssd(x, dt, A, B, C, chunk=32)
    want = ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), A, B, C).transpose(1, 2)
    assert _rel(got, want) < 1e-5
