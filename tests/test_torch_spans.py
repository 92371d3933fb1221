"""The substrate's spans (``repro_torch.obs.registry.span``) on the train
step and the prefill step, on the CPU at tiny widths: under
``recording`` each span is called as often as the work says (G forward
and backward spans a step, one ``apply_optimizer`` and one
``sync_model``, one ``prefill`` a request), and a registry installed
changes no number the step computes: masters, moments, the compute copy,
the loss and the prefill logits are bit-identical with one and without.
Plain PyTorch: nothing here imports JAX."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import RunCfg, init_params  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry, current, recording  # noqa: E402
from repro_torch.serving import make_prefill_step  # noqa: E402
from repro_torch.train.step import TrainCfg, init_train_state, make_train_step  # noqa: E402

G, STEPS, B, S = 2, 2, 1, 32
TRAIN = TrainCfg(run=RunCfg(compute_dtype=torch.bfloat16, param_dtype=torch.float32, remat=False),
                 num_microbatches=G)
TRAIN_SPANS = ("host.train.forward", "host.train.backward", "host.train.apply_optimizer",
               "host.train.sync_model")


def _train(registry):
    """STEPS steps of tiny mamba2 at G 2 from seed 0, under ``registry``
    when given; (state, losses)."""
    arch = scale_arch(get_config("mamba2-2.7b"), "tiny")
    state = init_train_state(arch, TRAIN, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(arch, TRAIN)
    data = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(STEPS):
        tokens = torch.randint(0, arch.vocab, (G, B, S + 1), generator=data)
        batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
        if registry is None:
            state, metrics = step(state, batch)
        else:
            with recording(registry):
                state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    return state, losses


def _prefill(registry, lengths=(24, 40, 17)):
    """Tiny yi-6b's prefill of one row a request; the logits of each."""
    arch = scale_arch(get_config("yi-6b"), "tiny")
    model = init_params(arch, torch.Generator().manual_seed(0), RunCfg(compute_dtype=torch.bfloat16),
                        device="cpu")
    prefill = make_prefill_step(model)
    data = torch.Generator().manual_seed(2)
    out = []
    for L in lengths:
        tokens = torch.randint(0, arch.vocab, (1, L), generator=data)
        if registry is None:
            out.append(prefill({"tokens": tokens}))
        else:
            with recording(registry):
                out.append(prefill({"tokens": tokens}))
    return out


def _calls(registry, names):
    counters = registry.to_dict()["counters"]
    return {n: counters.get(n + ".calls", 0) for n in names}


@pytest.fixture(scope="module")
def trained():
    reg = MetricsRegistry()
    return _train(None), _train(reg), reg


def test_train_spans_count_the_work(trained):
    _, _, reg = trained
    assert _calls(reg, TRAIN_SPANS) == {"host.train.forward": G * STEPS,
                                        "host.train.backward": G * STEPS,
                                        "host.train.apply_optimizer": STEPS,
                                        "host.train.sync_model": STEPS}
    counters = reg.to_dict()["counters"]
    assert all(counters[n + ".us"] > 0 for n in TRAIN_SPANS)
    assert current().to_dict() == {}


def test_train_step_is_bit_identical_with_a_registry(trained):
    (plain, plain_losses), (traced, traced_losses), _ = trained
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    for n in plain.params:
        assert torch.equal(plain.params[n], traced.params[n]), n
        assert torch.equal(plain.opt_state["m"][n], traced.opt_state["m"][n]), n
        assert torch.equal(plain.opt_state["v"][n], traced.opt_state["v"][n]), n
    copies = dict(traced.model.named_parameters())
    for n, w in plain.model.named_parameters():
        assert torch.equal(w, copies[n]), n
    assert torch.equal(plain.opt_state["step"], traced.opt_state["step"])


def test_prefill_span_counts_requests_and_changes_no_logit():
    reg = MetricsRegistry()
    plain, traced = _prefill(None), _prefill(reg)
    assert _calls(reg, ("host.serve.prefill",)) == {"host.serve.prefill": 3}
    assert reg.to_dict()["counters"]["host.serve.prefill.us"] > 0
    for a, b in zip(plain, traced):
        assert a.shape == (1, 1, a.shape[-1]) and torch.equal(a, b)
