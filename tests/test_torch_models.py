"""The port's decoder (dense and SSM) against ``repro.models.lm`` on the
same weights.

Weights come from the JAX ``init_params`` and cross as numpy
(``repro_torch.convert``); tokens come from numpy with a seed. The port
runs on the CPU, where its kernels take their plain versions.

Tolerances. fp32 compute: 1e-4, which leaves only summation order
between the two frameworks. bf16 compute: the reference's own bf16
logits differ from its fp32 logits by several percent at these weights
(the init draws wq/wk/wv at std (1/L)^0.5, so attention is sharp and
rounding is amplified), and the port rounds at other places (the
kernels keep fp32 where ``repro.models.layers`` rounds to bf16, see the
precision notes in ``repro_torch.models.layers``). So in bf16 the port
must sit within half of that bf16 noise of the reference, in relative
L2 norm, and pick the same next token at >= 95% of positions. bf16
decode differs from bf16 forward in the reference itself for mamba2 (its
decode keeps conv_b, A_log and dt_bias in fp32, its forward rounds them),
so the port's decode-vs-forward distance may exceed the reference's own by
that half of the noise.

MoE archs (dbrx-132b) run drop-free (capacity factor 8, as
tests/test_models.py:58-62): a decode step of B tokens has its own
capacity, so at the default one its drops differ from the forward's in
the reference too. In bf16 their routing flips near-ties in both
packages (ROADMAP §3), so, as tests/test_torch_hybrid_moe.py holds
granite-moe, the port's bf16 logits must sit no further from the
reference's fp32 ones than 1.25x the reference's own bf16 do.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.train import scale_arch as jax_scale_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import LM, RunCfg, init_params, param_count  # noqa: E402

ARCHS = ["yi-6b", "granite-3-8b", "minitron-4b", "mamba2-2.7b", "dbrx-132b", "nemotron-4-340b"]
B, S = 2, 12
DROP_FREE = 8.0         # tests/test_models.py:60


def _archs(name):
    return jax_scale_arch(jax_get_config(name), "tiny"), scale_arch(get_config(name), "tiny")


def _cfgs(dtype, name="yi-6b"):
    """Both packages' run configs; MoE archs drop-free."""
    cf = DROP_FREE if _archs(name)[1].n_experts else 1.25
    return (jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=getattr(jnp, dtype),
                       capacity_factor=cf),
            RunCfg(compute_dtype=getattr(torch, dtype), capacity_factor=cf))


def _tokens(arch, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, arch.vocab, shape).astype(np.int32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_decode(jarch, params, toks, jcfg):
    cache = jlm.init_cache(jarch, B, S + 4, jcfg)
    out = []
    for t in range(S):
        lg, cache = jlm.decode_step(jarch, params, cache, tokens=jnp.asarray(toks[:, t]),
                                    pos=jnp.int32(t), cfg=jcfg)
        out.append(np.asarray(lg))
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: JAX params (fp32), tokens, JAX forward logits in fp32 and
    bf16 compute, and JAX's own bf16 decode-vs-forward distance."""
    out = {}
    for name in ARCHS:
        jarch, _ = _archs(name)
        params = jlm.init_params(jarch, jax.random.PRNGKey(0), jlm.RunCfg())
        toks = _tokens(jarch)
        logits = {}
        for dtype in ("float32", "bfloat16"):
            jcfg, _ = _cfgs(dtype, name)
            logits[dtype] = np.asarray(jlm.forward(jarch, params, tokens=jnp.asarray(toks),
                                                   cfg=jcfg)[0])
        jcfg, _ = _cfgs("bfloat16", name)
        logits["decode_gap"] = _rel(_jax_decode(jarch, params, toks, jcfg), logits["bfloat16"])
        out[name] = (jax.tree.map(np.asarray, params), toks, logits)
    return out


def _port(name, tree, dtype):
    _, arch = _archs(name)
    return params_from_numpy(tree, arch, _cfgs(dtype, name)[1], device="cpu")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_runs, name, dtype):
    tree, toks, ref = jax_runs[name]
    model = _port(name, tree, dtype)
    with torch.inference_mode():
        logits = model(torch.as_tensor(toks)).numpy()
    assert logits.shape == ref[dtype].shape and logits.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(logits, ref["float32"], rtol=1e-4, atol=1e-4)
    elif model.arch.n_experts:
        noise = _rel(ref["bfloat16"], ref["float32"])
        assert _rel(logits, ref["float32"]) <= 1.25 * noise, (_rel(logits, ref["float32"]), noise)
    else:
        noise = _rel(ref["bfloat16"], ref["float32"])
        assert _rel(logits, ref["bfloat16"]) <= 0.5 * noise, (_rel(logits, ref["bfloat16"]), noise)
        agree = (logits.argmax(-1) == ref["bfloat16"].argmax(-1)).mean()
        assert agree >= 0.95, agree


@pytest.mark.parametrize("name", ARCHS)
def test_forward_last_position_matches_all(jax_runs, name):
    tree, toks, _ = jax_runs[name]
    model = _port(name, tree, "float32")
    with torch.inference_mode():
        full = model(torch.as_tensor(toks))
        last = model(torch.as_tensor(toks), logits_positions="last")
    assert last.shape == (B, 1, full.shape[-1])
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_teacher_forced_forward(jax_runs, name, dtype):
    """decode_step over the prompt reproduces forward's logits at every
    position (tests/test_models.py:55-85, KV cache and SSM state
    correctness). In bf16 the reference's own decode-vs-forward distance
    (0 for the attention archs) is added to the half-noise allowance."""
    tree, toks, ref = jax_runs[name]
    model = _port(name, tree, dtype)
    with torch.inference_mode():
        full = model(torch.as_tensor(toks)).numpy()
        cache = model.init_cache(B, S + 4)
        dec = torch.stack([model.decode_step(cache, torch.as_tensor(toks[:, t]), t)
                           for t in range(S)], dim=1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(dec, full, rtol=1e-4, atol=1e-4)
    elif model.arch.n_experts:       # routing flips: the forward's rule, on the decode
        noise = _rel(ref["bfloat16"], ref["float32"])
        assert _rel(dec, ref["float32"]) <= 1.25 * noise, (_rel(dec, ref["float32"]), noise)
    else:
        noise = _rel(ref["bfloat16"], ref["float32"])
        limit = ref["decode_gap"] + 0.5 * noise
        assert _rel(dec, full) <= limit, (_rel(dec, full), ref["decode_gap"], noise)
        assert (dec.argmax(-1) == full.argmax(-1)).mean() >= 0.95


def test_sliding_window_decode_uses_a_ring_buffer():
    """A window arch keeps ``window`` cache slots; decoding past them
    matches the windowed forward (tests/test_models.py:120-129 analogue)."""
    _, arch = _archs("yi-6b")
    arch = dataclasses.replace(arch, window=5)
    model = init_params(arch, torch.Generator().manual_seed(1), RunCfg(torch.float32),
                        device="cpu")
    toks = torch.as_tensor(_tokens(arch, seed=3))
    with torch.inference_mode():
        full = model(toks)
        cache = model.init_cache(B, S)
        assert cache["k"].shape[2] == 5
        dec = torch.stack([model.decode_step(cache, toks[:, t], t) for t in range(S)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


# uniform SSM leaves: (map to the drawn value, its range); a few dozen
# values, too few for a std ratio within 10%
UNIFORM_LEAVES = {"A_log": (np.exp, 1.0, 16.0),
                  "dt_bias": (lambda a: np.logaddexp(a, 0), 1e-3, 1e-1)}


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_scales_and_count_match_jax(jax_runs, name):
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
        if path[-1].key in UNIFORM_LEAVES:
            draw, lo, hi = UNIFORM_LEAVES[path[-1].key]
            for a in (got, ref):
                assert lo * (1 - 1e-5) <= draw(a).min() and draw(a).max() <= hi * (1 + 1e-5), path
        elif ref.std() == 0:
            np.testing.assert_array_equal(got, ref)          # norms: ones
        else:
            assert abs(got.std() / ref.std() - 1) < 0.1, (path, got.std(), ref.std())
    assert param_count(model) == jlm.param_count(tree)


def test_ssm_fp32_leaves_stay_fp32_in_a_bf16_model(jax_runs):
    """conv_b, A_log, D and dt_bias stay fp32 in a bf16 model: its decode
    reads them in fp32, as the reference's does; the rest is bf16."""
    tree, _, _ = jax_runs["mamba2-2.7b"]
    model = _port("mamba2-2.7b", tree, "bfloat16")
    for name, p in model.named_parameters():
        fp32 = name.rsplit(".", 1)[-1] in ("conv_b", "A_log", "D", "dt_bias")
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name


def test_unported_archs_raise():
    """Every arch of the zoo is ported (the embeds-input ones since their
    slice, tests/test_torch_embeds.py); a block the port does not know
    still raises."""
    arch = dataclasses.replace(scale_arch(get_config("yi-6b"), "tiny"), block="rwkv")
    with pytest.raises(NotImplementedError, match="unknown"):
        LM(arch, device="cpu")
