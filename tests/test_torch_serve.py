"""The port's serving entry points against ``repro.serving.serve`` on the
same weights (JAX ``init_params``, crossed as numpy) and the same tokens
(numpy, seeded). In fp32 compute the greedy tokens must be equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.train import scale_arch as jax_scale_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import serve as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import RunCfg  # noqa: E402
from repro_torch.serving import greedy_generate, make_prefill_step, make_serve_step  # noqa: E402

ARCHS = ["yi-6b", "granite-3-8b", "minitron-4b", "mamba2-2.7b", "dbrx-132b", "nemotron-4-340b"]
JCFG = jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=jnp.float32)
TCFG = RunCfg(compute_dtype=torch.float32)


def _setup(name, seed=0):
    jarch = jax_scale_arch(jax_get_config(name), "tiny")
    params = jlm.init_params(jarch, jax.random.PRNGKey(seed), jlm.RunCfg())
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              scale_arch(get_config(name), "tiny"), TCFG, device="cpu")
    return jarch, params, model


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_jax(name):
    jarch, params, model = _setup(name)
    toks = np.random.default_rng(1).integers(0, jarch.vocab, (2, 16)).astype(np.int32)
    ref = jserve.make_prefill_step(jarch, JCFG)(params, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(model)({"tokens": toks})
    assert out.shape == ref.shape == (2, 1, jarch.vocab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_generate_tokens_equal_jax(name):
    jarch, params, model = _setup(name)
    prompt = np.random.default_rng(2).integers(0, jarch.vocab, (3, 7)).astype(np.int32)
    ref = jserve.greedy_generate(jarch, params, jnp.asarray(prompt), 9, cfg=JCFG)
    out = greedy_generate(model, prompt, 9)
    assert out.shape == (3, 9) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_serve_step_matches_jax():
    jarch, params, model = _setup("yi-6b")
    toks = np.random.default_rng(3).integers(0, jarch.vocab, (2, 5)).astype(np.int32)
    jstep = jserve.make_serve_step(jarch, JCFG)
    jcache = jlm.init_cache(jarch, 2, 8, JCFG)
    step = make_serve_step(model)
    cache = model.init_cache(2, 8)
    for pos in range(toks.shape[1]):
        jnext, jlogits, jcache = jstep(params, jcache, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        nxt, logits, cache = step(cache, toks[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-4, atol=1e-4)


def test_ssm_serve_step_and_caches_match_jax():
    """mamba2's serve step: logits, tokens and the conv and SSM caches
    (updated in place) against the reference's new cache, step by step."""
    jarch, params, model = _setup("mamba2-2.7b")
    toks = np.random.default_rng(4).integers(0, jarch.vocab, (2, 6)).astype(np.int32)
    jstep = jserve.make_serve_step(jarch, JCFG)
    jcache = jlm.init_cache(jarch, 2, 8, JCFG)
    step = make_serve_step(model)
    cache = model.init_cache(2, 8)
    assert sorted(cache) == sorted(jcache) == ["conv", "ssm"]
    assert cache["ssm"].dtype == torch.float32
    for pos in range(toks.shape[1]):
        jnext, jlogits, jcache = jstep(params, jcache, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        nxt, logits, cache = step(cache, toks[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                       rtol=1e-4, atol=1e-4)


def test_greedy_generate_needs_a_new_token():
    _, _, model = _setup("yi-6b")
    with pytest.raises(ValueError):
        greedy_generate(model, np.zeros((1, 3), np.int32), 0)
