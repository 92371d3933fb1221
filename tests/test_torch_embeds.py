"""The port's embeds-input archs against ``repro.models.lm`` and
``repro.serving.serve`` on the same weights: hubert-xlarge (an encoder:
``causal=False``, GELU MLP, no decode) and llava-next-34b (a causal VLM
backbone with GQA, decoded from embeddings), both at
``scale_arch(..., "tiny")``.

Weights come from the JAX ``init_params`` (which makes no ``embed`` leaf
for these archs) and cross as numpy (``repro_torch.convert``); embeddings
and labels come from numpy with a seed. The port runs on the CPU, where
its kernels take their plain versions.

Tolerances are those of tests/test_torch_models.py: fp32 logits within
1e-4 (summation order only), bf16 logits within half of the reference's
own bf16-vs-fp32 distance in relative L2 with >= 95% argmax agreement;
the loss within 1e-5 relative (tests/torch_train_common.py's bound). The
training tests are tests/torch_train_common.py's, on tiny hubert-xlarge
(``setup``/``name`` below), without ``test_train_loop_loss_decreases``:
the synthetic stream of an embeds arch draws fresh random embeddings and
labels every step, so there is nothing for the loss to learn.
"""

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
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import LM, RunCfg, init_params, loss_fn, param_count  # noqa: E402
from repro_torch.serving import make_prefill_step, make_serve_step  # noqa: E402

from torch_train_common import (  # noqa: E402,F401
    build_setup, one_torch_thread, test_loss_and_grads_match_jax_fp32,
    test_loss_and_grads_match_jax_bf16, test_remat_gives_the_same_grads,
    test_eval_step_matches_loss_fn, test_train_step_g2_matches_jax,
    test_jax_checkpoint_restores_into_the_port, test_port_checkpoint_restores_into_jax,
    test_bf16_moments_do_not_checkpoint,
    test_jax_bf16_checkpoint_restores_into_the_port_bit_exactly,
    test_port_bf16_checkpoint_writes_the_reference_bytes, test_port_round_trips_bf16_moments,
    test_train_restart_resumes_deterministically, test_scaled_down_arch_is_the_reference_one,
    test_main_runs_on_the_cpu)

ARCHS = ["hubert-xlarge", "llava-next-34b"]
B, S = 2, 12


@pytest.fixture(scope="module", params=["hubert-xlarge"])
def setup(request):
    return build_setup(request.param)


@pytest.fixture(params=["hubert-xlarge"])
def name(request):
    return request.param


def _archs(name):
    return jax_scale_arch(jax_get_config(name), "tiny"), scale_arch(get_config(name), "tiny")


def _cfgs(dtype):
    return (jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=getattr(jnp, dtype)),
            RunCfg(compute_dtype=getattr(torch, dtype)))


def _embeds(arch, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).standard_normal((*shape, arch.d_model)).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: JAX params (fp32, as numpy), embeddings, and JAX's forward
    logits over them in fp32 and bf16 compute."""
    out = {}
    for name in ARCHS:
        jarch, _ = _archs(name)
        params = jlm.init_params(jarch, jax.random.PRNGKey(0), jlm.RunCfg())
        emb = _embeds(jarch)
        logits = {dtype: np.asarray(jlm.forward(jarch, params, embeds=jnp.asarray(emb),
                                                cfg=_cfgs(dtype)[0])[0])
                  for dtype in ("float32", "bfloat16")}
        out[name] = (jax.tree.map(np.asarray, params), emb, logits)
    return out


def _port(name, tree, dtype):
    return params_from_numpy(tree, _archs(name)[1], _cfgs(dtype)[1], device="cpu")


def test_the_reference_trees_have_no_embed_leaf(jax_runs):
    for name in ARCHS:
        tree = jax_runs[name][0]
        assert "embed" not in tree and "lm_head" in tree
        model = _port(name, tree, "float32")
        assert not hasattr(model, "embed")
        back = params_to_numpy(model)
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert flat_ref.keys() == flat_back.keys()
        for path, a in flat_ref.items():
            np.testing.assert_array_equal(flat_back[path], a)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_from_embeds_matches_jax(jax_runs, name, dtype):
    tree, emb, ref = jax_runs[name]
    model = _port(name, tree, dtype)
    with torch.inference_mode():
        logits = model(embeds=torch.from_numpy(emb)).numpy()
    assert logits.shape == ref[dtype].shape == (B, S, model.arch.vocab)
    assert logits.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(logits, ref["float32"], rtol=1e-4, atol=1e-4)
    else:
        noise = _rel(ref["bfloat16"], ref["float32"])
        assert _rel(logits, ref["bfloat16"]) <= 0.5 * noise, (_rel(logits, ref["bfloat16"]), noise)
        agree = (logits.argmax(-1) == ref["bfloat16"].argmax(-1)).mean()
        assert agree >= 0.95, agree


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_loss_from_embeds_matches_jax(jax_runs, name, masked):
    tree, emb, _ = jax_runs[name]
    jarch, arch = _archs(name)
    rng = np.random.default_rng(5)
    batch = {"embeds": emb, "labels": rng.integers(0, arch.vocab, (B, S)).astype(np.int32)}
    if masked:
        batch["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    jl, _ = jlm.loss_fn(jarch, tree, {k: jnp.asarray(v) for k, v in batch.items()},
                        _cfgs("float32")[0])
    with torch.inference_mode():
        loss, metrics = loss_fn(_port(name, tree, "float32"),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(metrics["loss"]) == float(loss)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_from_embeds_matches_jax(jax_runs, name):
    """The reference's prefill keeps every position's logits for the
    encoder (``repro/serving/serve.py:78``) and the last for llava."""
    tree, _, _ = jax_runs[name]
    jarch, arch = _archs(name)
    emb = _embeds(arch, seed=1, shape=(2, 16))
    ref = jserve.make_prefill_step(jarch, _cfgs("float32")[0])(tree, {"embeds": jnp.asarray(emb)})
    out = make_prefill_step(_port(name, tree, "float32"))({"embeds": emb})
    want = (2, 16 if name == "hubert-xlarge" else 1, arch.vocab)
    assert out.shape == ref.shape == want
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_llava_serve_step_from_embeds_matches_jax(jax_runs):
    """llava's decode from embeddings [B,H] through ``make_serve_step``
    against the reference's ``serve_step`` (``decode_step(embeds=)``), step
    by step: logits within 1e-4, greedy tokens equal, the KV cache too."""
    tree, _, _ = jax_runs["llava-next-34b"]
    jarch, arch = _archs("llava-next-34b")
    emb = _embeds(arch, seed=2, shape=(2, 6))
    jcfg = _cfgs("float32")[0]
    jstep, jcache = jserve.make_serve_step(jarch, jcfg), jlm.init_cache(jarch, 2, 8, jcfg)
    model = _port("llava-next-34b", tree, "float32")
    step, cache = make_serve_step(model), model.init_cache(2, 8)
    for pos in range(emb.shape[1]):
        jnext, jlogits, jcache = jstep(tree, jcache, jnp.asarray(emb[:, pos]), jnp.int32(pos))
        nxt, logits, cache = step(cache, emb[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), rtol=1e-4,
                                   atol=1e-4)


def test_llava_decode_matches_its_teacher_forced_forward(jax_runs):
    """decode_step over the embeddings reproduces the forward's logits at
    every position (tests/test_models.py:55-85, from embeddings)."""
    tree, emb, _ = jax_runs["llava-next-34b"]
    model = _port("llava-next-34b", tree, "float32")
    x = torch.from_numpy(emb)
    with torch.inference_mode():
        full = model(embeds=x)
        cache = model.init_cache(B, S + 4)
        dec = torch.stack([model.decode_step(cache, None, t, embeds=x[:, t]) for t in range(S)],
                          dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_and_count_match_jax(jax_runs, name):
    tree, _, _ = jax_runs[name]
    _, arch = _archs(name)
    model = init_params(arch, torch.Generator().manual_seed(0), RunCfg(torch.float32),
                        device="cpu")
    mine = params_to_numpy(model)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_mine = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert flat_ref.keys() == flat_mine.keys()
    for path, ref in flat_ref.items():
        got = flat_mine[path]
        assert got.shape == ref.shape, path
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref)          # norms: ones
        else:
            assert abs(got.std() / ref.std() - 1) < 0.1, (path, got.std(), ref.std())
    assert param_count(model) == jlm.param_count(tree)


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_models_construct_with_their_param_counts(name):
    """The full configs build (on the meta device: no memory) with no
    embed table and the config's parameter count (which leaves out the
    final norm's H); hubert's attention runs at head_dim 80, non-causal."""
    arch = get_config(name)
    model = LM(arch, RunCfg(), device="meta")
    assert not hasattr(model, "embed")
    assert param_count(model) == round(arch.param_count()) + arch.d_model
    if name == "hubert-xlarge":
        assert (arch.head_dim, arch.causal) == (80, False)


@pytest.mark.parametrize("name", ARCHS)
def test_the_missing_input_raises(jax_runs, name):
    tree, _, _ = jax_runs[name]
    model = _port(name, tree, "float32")
    with pytest.raises(ValueError, match="embeddings"):
        model(torch.zeros(B, S, dtype=torch.long))
    with pytest.raises(ValueError, match="embeddings"):
        loss_fn(model, {"tokens": torch.zeros(B, S, dtype=torch.long),
                        "labels": torch.zeros(B, S, dtype=torch.long)})
