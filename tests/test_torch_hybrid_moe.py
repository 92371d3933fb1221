"""The port's hybrid block (hymba-1.5b) and MoE layer (granite-moe-3b-a800m)
against ``repro.models`` on the same weights.

Weights come from the JAX ``init_params`` and cross as numpy
(``repro_torch.convert``); tokens and MoE inputs come from numpy with a
seed. The archs are tiny (``scale_arch(..., "tiny")``): hymba keeps a
window of 64, granite 4 experts and top-2. The port runs on the CPU,
where its kernels take their plain versions.

Tolerances. fp32: 1e-4 for logits (summation order only, as
tests/test_torch_models.py), 2e-2 for decode against the teacher-forced
forward (tests/test_models.py:83-85), and the MoE layer's outputs at
1e-5; its ``load`` and ``drop_fraction`` must be equal exactly (random
fp32 router inputs, so top-k meets no tie). bf16, hymba: half of the
reference's own bf16-vs-fp32 distance and >= 95% argmax agreement, the
rule of tests/test_torch_models.py. bf16, MoE: routing turns on near-ties,
and one token of 24 that picks another expert pair in layer 1 puts the
port's bf16 logits 0.146 relative L2 from the reference's bf16 (half the
noise is 0.087; ROADMAP §3), so the model is held to the gradients' rule
of tests/torch_train_common.py instead: relative L2 no further from the
reference's fp32 than 1.25x the reference's own bf16 (read: 0.95x),
drop-free (capacity factor 8, as tests/test_models.py:58-62), where one
flipped token moves no other token's slot. Argmax agreement is not gated
there: over 24 positions one flipped argmax is 0.04. The bf16 MoE layer
alone, on the same bf16 inputs, rounds independently of the reference
(port to reference bf16 0.0053, each to fp32 0.0062 and 0.0068), so it
is held to the same 1.25x rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.train import scale_arch as jax_scale_arch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import serve as jserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import RunCfg, init_params, loss_fn, param_count  # noqa: E402
from repro_torch.serving import greedy_generate, make_prefill_step  # noqa: E402

HYMBA, GRANITE = "hymba-1.5b", "granite-moe-3b-a800m"
DROP_FREE = 8.0          # tests/test_models.py:60
B, S = 2, 12
S_WRAP = 80              # past tiny hymba's window of 64: the KV ring wraps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _archs(name):
    return jax_scale_arch(jax_get_config(name), "tiny"), scale_arch(get_config(name), "tiny")


def _cfgs(dtype, cf=1.25):
    return (jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=getattr(jnp, dtype),
                       capacity_factor=cf),
            RunCfg(compute_dtype=getattr(torch, dtype), capacity_factor=cf))


def _tokens(arch, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, arch.vocab, shape).astype(np.int32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def trees():
    """The reference's init (PRNGKey(0)) of each tiny arch, as numpy."""
    return {name: jax.tree.map(np.asarray, jlm.init_params(_archs(name)[0],
                                                           jax.random.PRNGKey(0), jlm.RunCfg()))
            for name in (HYMBA, GRANITE)}


def _jax_forward(name, tree, toks, dtype, cf=1.25):
    jarch, _ = _archs(name)
    logits, aux = jlm.forward(jarch, tree, tokens=jnp.asarray(toks), cfg=_cfgs(dtype, cf)[0])
    return np.asarray(logits, np.float32), aux


def _port(name, tree, dtype, cf=1.25):
    return params_from_numpy(tree, _archs(name)[1], _cfgs(dtype, cf)[1], device="cpu")


def _forward(model, toks):
    with torch.inference_mode():
        return model(torch.as_tensor(toks)).numpy()


def _decode(model, toks):
    """The port's decode over every position of ``toks``: [B,S,V]."""
    with torch.inference_mode():
        cache = model.init_cache(toks.shape[0], toks.shape[1])
        return torch.stack([model.decode_step(cache, torch.as_tensor(toks[:, t]), t)
                            for t in range(toks.shape[1])], dim=1).numpy()


def _jax_decode(name, tree, toks, dtype, cf=1.25):
    jarch, _ = _archs(name)
    jcfg = _cfgs(dtype, cf)[0]
    cache = jlm.init_cache(jarch, toks.shape[0], toks.shape[1], jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(lambda c, tok, pos: jlm.decode_step(jarch, params, c, tokens=tok, pos=pos,
                                                       cfg=jcfg))
    out = []
    for t in range(toks.shape[1]):
        lg, cache = step(cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        out.append(np.asarray(lg))
    return np.stack(out, axis=1)


# ------------------------------------------------------------------ hymba

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_forward_matches_jax(trees, dtype):
    toks = _tokens(_archs(HYMBA)[1])
    ref = {dt: _jax_forward(HYMBA, trees[HYMBA], toks, dt)[0] for dt in ("float32", dtype)}
    logits = _forward(_port(HYMBA, trees[HYMBA], dtype), toks)
    assert logits.shape == ref[dtype].shape and logits.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(logits, ref["float32"], rtol=1e-4, atol=1e-4)
    else:
        noise = _rel(ref["bfloat16"], ref["float32"])
        assert _rel(logits, ref["bfloat16"]) <= 0.5 * noise, (_rel(logits, ref["bfloat16"]), noise)
        assert (logits.argmax(-1) == ref["bfloat16"].argmax(-1)).mean() >= 0.95


def test_hymba_forward_past_the_window_matches_jax(trees):
    """S = 80 over a window of 64: the windowed attention masks keys past it."""
    toks = _tokens(_archs(HYMBA)[1], seed=1, shape=(B, S_WRAP))
    ref, _ = _jax_forward(HYMBA, trees[HYMBA], toks, "float32")
    np.testing.assert_allclose(_forward(_port(HYMBA, trees[HYMBA], "float32"), toks), ref,
                               rtol=1e-4, atol=1e-4)


def test_hymba_decode_across_a_wrapped_ring_matches_jax(trees):
    """The port's decode against the reference's ``decode_step`` over 80
    positions with a 64-slot KV ring beside the conv and SSM caches, and
    against the port's own teacher-forced forward."""
    _, arch = _archs(HYMBA)
    toks = _tokens(arch, seed=1, shape=(B, S_WRAP))
    model = _port(HYMBA, trees[HYMBA], "float32")
    cache = model.init_cache(B, S_WRAP)
    assert cache["k"].shape[2] == arch.window and set(cache) == {"k", "v", "conv", "ssm"}
    assert cache["ssm"].dtype == torch.float32
    dec = _decode(model, toks)
    np.testing.assert_allclose(dec, _jax_decode(HYMBA, trees[HYMBA], toks, "float32"),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dec, _forward(model, toks), rtol=2e-2, atol=2e-2)


def test_hymba_bf16_decode_matches_teacher_forced_forward(trees):
    """bf16: the reference's own decode-vs-forward distance (its decode keeps
    the SSM's fp32 leaves, its forward rounds them) plus half the bf16 noise,
    as tests/test_torch_models.py holds mamba2."""
    toks = _tokens(_archs(HYMBA)[1])
    tree = trees[HYMBA]
    ref = {dt: _jax_forward(HYMBA, tree, toks, dt)[0] for dt in ("float32", "bfloat16")}
    gap = _rel(_jax_decode(HYMBA, tree, toks, "bfloat16"), ref["bfloat16"])
    model = _port(HYMBA, tree, "bfloat16")
    dec, full = _decode(model, toks), _forward(model, toks)
    limit = gap + 0.5 * _rel(ref["bfloat16"], ref["float32"])
    assert _rel(dec, full) <= limit, (_rel(dec, full), gap)
    assert (dec.argmax(-1) == full.argmax(-1)).mean() >= 0.95


def test_hymba_ssm_leaves_stay_fp32_in_a_bf16_model(trees):
    model = _port(HYMBA, trees[HYMBA], "bfloat16")
    names = {n for n, _ in model.named_parameters()}
    for group in ("attn", "ssm", "mlp"):
        assert any(f".{group}." in n for n in names), group
    for name, p in model.named_parameters():
        fp32 = name.rsplit(".", 1)[-1] in ("conv_b", "A_log", "D", "dt_bias")
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name


# ------------------------------------------------------------------ the MoE layer

def _moe_inputs(seed=0, T=24, H=128, E=4, F=128):
    """Random fp32 tokens and expert weights at unit-scale products."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H)).astype(np.float32)
    p = {"router": 0.05 * rng.standard_normal((H, E)),
         "wg": rng.standard_normal((E, H, F)) / H ** 0.5,
         "wi": rng.standard_normal((E, H, F)) / H ** 0.5,
         "wo": rng.standard_normal((E, F, H)) / F ** 0.5}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _both_moe(x, p, cf, dtype, top_k=2):
    jmoe = jax.jit(jlayers.moe, static_argnums=(2, 3, 4))
    jo, ja = jmoe(jnp.asarray(x).astype(getattr(jnp, dtype)),
                  {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in p.items()},
                  top_k, cf, True)
    to, ta = layers.moe(torch.from_numpy(x).to(getattr(torch, dtype)),
                        {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in p.items()},
                        top_k, cf, True)
    return (np.asarray(jo, np.float32), jax.tree.map(np.asarray, ja)), \
        (to.float().numpy(), {k: v.numpy() for k, v in ta.items()})


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, DROP_FREE])
def test_moe_layer_matches_jax_fp32(cf):
    """Capacity 6, 12, 15 and 96 slots for 48 assignments: 0.5 and 1.0 drop."""
    x, p = _moe_inputs()
    (jo, ja), (to, ta) = _both_moe(x, p, cf, "float32")
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ta["load"], ja["load"])
    assert ta["drop_fraction"].dtype == np.float32
    assert ta["drop_fraction"] == ja["drop_fraction"]
    assert (ta["drop_fraction"] > 1e-6) == (cf <= 1.0)     # no drop reads -2^-25
    np.testing.assert_allclose(ta["router_entropy"], ja["router_entropy"], rtol=1e-6)


def test_moe_layer_matches_jax_bf16_drop_free():
    x, p = _moe_inputs(seed=1)
    (j32, _), _ = _both_moe(x, p, DROP_FREE, "float32")
    (jo, ja), (to, ta) = _both_moe(x, p, DROP_FREE, "bfloat16")
    np.testing.assert_array_equal(ta["load"], ja["load"])
    noise = _rel(jo, j32)
    assert _rel(to, j32) <= 1.25 * noise, (_rel(to, j32), noise)


def test_moe_layer_gradient_skips_dropped_tokens():
    """A dropped assignment adds nothing to the output and takes no
    gradient: with every slot taken by the first tokens, the last token's
    gradient is 0 and the first ones' is not."""
    x, p = _moe_inputs(seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = layers.moe(xt, {k: torch.from_numpy(v) for k, v in p.items()}, 2, 0.25)
    C = int(max(1, 0.25 * 2 * x.shape[0] / 4))
    out.sum().backward()
    assert float(aux["drop_fraction"]) > 0.5
    assert torch.count_nonzero(xt.grad.abs().sum(-1)) <= 4 * C
    assert xt.grad[0].abs().sum() > 0


# ------------------------------------------------------------------ granite-moe

@pytest.mark.parametrize("cf", [1.0, DROP_FREE])
def test_granite_forward_and_loss_metrics_match_jax(trees, cf):
    """fp32 logits; ``loss_fn``'s ``moe_drop`` and ``moe_load_max`` (means
    over the layers) equal the reference's, with drops (cf 1.0) and without."""
    jarch, arch = _archs(GRANITE)
    toks = _tokens(arch, seed=4, shape=(B, 24))
    ref, _ = _jax_forward(GRANITE, trees[GRANITE], toks, "float32", cf)
    model = _port(GRANITE, trees[GRANITE], "float32", cf)
    np.testing.assert_allclose(_forward(model, toks), ref, rtol=1e-4, atol=1e-4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, jm = jlm.loss_fn(jarch, trees[GRANITE], {k: jnp.asarray(v) for k, v in batch.items()},
                            _cfgs("float32", cf)[0])
    with torch.inference_mode():
        loss, m = loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(m) == sorted(jm) == ["loss", "moe_drop", "moe_load_max"]
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(m["moe_load_max"]) == float(jm["moe_load_max"])
    assert float(m["moe_drop"]) == float(jm["moe_drop"])
    assert (float(m["moe_drop"]) > 0) == (cf == 1.0)


def test_granite_bf16_forward_is_as_close_to_fp32_as_jax_bf16(trees):
    toks = _tokens(_archs(GRANITE)[1])
    ref = {dt: _jax_forward(GRANITE, trees[GRANITE], toks, dt, DROP_FREE)[0]
           for dt in ("float32", "bfloat16")}
    logits = _forward(_port(GRANITE, trees[GRANITE], "bfloat16", DROP_FREE), toks)
    noise = _rel(ref["bfloat16"], ref["float32"])
    assert _rel(logits, ref["float32"]) <= 1.25 * noise, (_rel(logits, ref["float32"]), noise)


def test_granite_decode_matches_forward_drop_free(trees):
    """Drop-free, decode (one token a step, so its own capacity) reproduces
    the teacher-forced forward and the reference's decode."""
    toks = _tokens(_archs(GRANITE)[1])
    model = _port(GRANITE, trees[GRANITE], "float32", DROP_FREE)
    dec = _decode(model, toks)
    np.testing.assert_allclose(dec, _forward(model, toks), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dec, _jax_decode(GRANITE, trees[GRANITE], toks, "float32",
                                                DROP_FREE), rtol=1e-4, atol=1e-4)


def test_granite_decode_drops_as_the_reference(trees):
    """At the default capacity a decode step of B = 2 tokens has C = 1 slot
    an expert, so tokens that share an expert drop: the reference's decode
    semantics, reproduced."""
    toks = _tokens(_archs(GRANITE)[1], seed=5)
    model = _port(GRANITE, trees[GRANITE], "float32")
    np.testing.assert_allclose(_decode(model, toks),
                               _jax_decode(GRANITE, trees[GRANITE], toks, "float32"),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ both

@pytest.mark.parametrize("name", [HYMBA, GRANITE])
def test_init_params_shapes_scales_and_count_match_jax(trees, name):
    tree = trees[name]
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
        if path[-1].key in ("A_log", "dt_bias"):        # uniform draws, checked by shape
            continue
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref)      # norms, D, conv_b
        else:
            assert abs(got.std() / ref.std() - 1) < 0.1, (path, got.std(), ref.std())
    assert param_count(model) == jlm.param_count(tree)


@pytest.mark.parametrize("name", [HYMBA, GRANITE])
def test_serving_matches_jax(trees, name):
    """fp32 at the default capacity: prefill's last logits and greedy tokens
    equal the reference's (``repro.serving.serve``)."""
    jarch, arch = _archs(name)
    jcfg, cfg = _cfgs("float32")
    tree = trees[name]
    model = params_from_numpy(tree, arch, cfg, device="cpu")
    toks = _tokens(arch, seed=6, shape=(2, 16))
    ref = jserve.make_prefill_step(jarch, jcfg)(tree, {"tokens": jnp.asarray(toks)})
    out = make_prefill_step(model)({"tokens": toks})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    prompt = _tokens(arch, seed=7, shape=(3, 7))
    want = jserve.greedy_generate(jarch, tree, jnp.asarray(prompt), 9, cfg=jcfg)
    np.testing.assert_array_equal(greedy_generate(model, prompt, 9).numpy(), np.asarray(want))


def test_block_leaves_follow_the_reference_tree():
    """Hymba's block holds attention, the SSM and the MLP; granite-moe's
    holds experts [E,H,F] and no MLP."""
    _, hymba = _archs(HYMBA)
    _, granite = _archs(GRANITE)
    h = init_params(hymba, torch.Generator().manual_seed(0), RunCfg(torch.float32), device="cpu")
    g = init_params(granite, torch.Generator().manual_seed(0), RunCfg(torch.float32),
                    device="cpu")
    assert all(hasattr(h.blocks[0], k) for k in ("attn", "ssm", "mlp", "norm2"))
    assert hasattr(g.blocks[0], "moe") and not hasattr(g.blocks[0], "mlp")
    assert tuple(g.blocks[0].moe["wg"].shape) == (granite.n_experts, granite.d_model,
                                                  granite.d_ff_expert)
