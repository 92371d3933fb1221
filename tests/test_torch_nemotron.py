"""nemotron-4-340b's attention shape at a size the CPU holds: the port's
model at head_dim 192 against ``repro.models.lm`` on the same weights.

``scale_arch(..., "tiny")`` gives every arch head_dim 32, while the port's
kernels serve nemotron at hd 192, an instantiation of their own. So
nemotron's config is cut here to 2 layers, d_model 384, 2 query heads and 1
KV head of hd 192, d_ff 768 (squared-ReLU, not gated), vocab 256. Weights
from the JAX ``init_params`` cross as numpy (``repro_torch.convert``);
tokens come from numpy with a seed; the port runs on the CPU, where its
kernels take their plain versions.

Tolerances are tests/test_torch_models.py's (tests/test_models.py:83-85):
fp32 logits at 1e-4, decode against the forward at 2e-2 and 1e-4; bf16
within half of the reference's own bf16 noise, argmax agreement >= 0.95.
Gradients: tests/torch_train_common.py's bf16 test (within 1.25x the
reference's own bf16 distance from fp32, under the reference's init and
under fan-in H), and fp32 at its 1e-4 relative L2 under fan-in H. fp32
under the reference's init is not a comparison of the two packages here:
with L = 2 it draws wq and wk at std 0.71 (fan-in from the layer axis,
ROADMAP §3), attention is a hard argmax, and on microbatch 0 the
reference's own fp32 gradient of wq sits 3.4e-3 relative L2 from fp64 (the
port in fp64), the port's 6.2e-3 with one torch thread and 1.0e-3 with
four: summation order, not the math.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.lm import RunCfg  # noqa: E402
from repro_torch.train.data import DataCfg, SyntheticDataset  # noqa: E402
from torch_train_common import (  # noqa: E402,F401
    FP32_GRAD_TOL, INITS, _jax_loss_grads, _port_loss_grads, one_torch_thread,
    test_loss_and_grads_match_jax_bf16)

CUT = dict(num_layers=2, d_model=384, n_heads=2, n_kv=1, head_dim=192, d_ff=768, vocab=256)
B, S = 2, 12


def _archs():
    return (dataclasses.replace(jax_get_config("nemotron-4-340b"), **CUT),
            dataclasses.replace(get_config("nemotron-4-340b"), **CUT))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup():
    """tests/torch_train_common.py's ``setup``: both archs, the reference's
    init as numpy, and one batch of its synthetic stream."""
    jarch, arch = _archs()
    params = jax.tree.map(np.asarray, jlm.init_params(jarch, jax.random.PRNGKey(0),
                                                      jlm.RunCfg()))
    batch = SyntheticDataset(arch, DataCfg(seq_len=24, global_batch=4, num_microbatches=2,
                                           seed=3)).batch_at(0)
    return jarch, arch, params, batch


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Tokens, and the reference's forward logits in fp32 and bf16 compute
    and its fp32 decode logits, on ``setup``'s weights."""
    jarch, _, params, _ = setup
    toks = np.random.default_rng(0).integers(0, jarch.vocab, (B, S)).astype(np.int32)
    out = {"tokens": toks}
    for dtype in ("float32", "bfloat16"):
        cfg = jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=getattr(jnp, dtype))
        out[dtype] = np.asarray(jlm.forward(jarch, params, tokens=jnp.asarray(toks), cfg=cfg)[0])
    cfg = jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=jnp.float32)
    cache = jlm.init_cache(jarch, B, S + 4, cfg)
    dec = []
    for t in range(S):
        lg, cache = jlm.decode_step(jarch, params, cache, tokens=jnp.asarray(toks[:, t]),
                                    pos=jnp.int32(t), cfg=cfg)
        dec.append(np.asarray(lg))
    out["decode"] = np.stack(dec, axis=1)
    return out


def _port(setup, dtype):
    _, arch, params, _ = setup
    return params_from_numpy(params, arch, RunCfg(compute_dtype=getattr(torch, dtype)),
                             device="cpu")


def test_the_cut_keeps_nemotron_s_attention_and_mlp(setup):
    """hd 192 with a GQA group (2 query heads a KV head), the squared-ReLU
    MLP without a gate, untied embed and head: nemotron's own, cut in size
    only."""
    jarch, arch, params, _ = setup
    full = get_config("nemotron-4-340b")
    assert arch.head_dim == full.head_dim == 192 and jarch.head_dim == 192
    assert (arch.mlp, arch.block, arch.family) == (full.mlp, full.block, full.family)
    assert "wg" not in params["layers"]["mlp"] and "lm_head" in params
    assert arch.n_heads // arch.n_kv == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(setup, jax_runs, dtype):
    model = _port(setup, dtype)
    with torch.inference_mode():
        logits = model(torch.as_tensor(jax_runs["tokens"])).numpy()
    ref = jax_runs[dtype]
    assert logits.shape == ref.shape and logits.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-4)
        return
    noise = _rel(jax_runs["bfloat16"], jax_runs["float32"])
    assert _rel(logits, ref) <= 0.5 * noise, (_rel(logits, ref), noise)
    assert (logits.argmax(-1) == ref.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_and_the_forward(setup, jax_runs, dtype):
    """decode_step over the prompt against the port's own forward (as
    tests/test_torch_models.py) and, in fp32, against the reference's
    decode_step."""
    model = _port(setup, dtype)
    toks = jax_runs["tokens"]
    with torch.inference_mode():
        full = model(torch.as_tensor(toks)).numpy()
        cache = model.init_cache(B, S + 4)
        assert cache["k"].shape[-1] == 192
        dec = torch.stack([model.decode_step(cache, torch.as_tensor(toks[:, t]), t)
                           for t in range(S)], dim=1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(dec, full, rtol=1e-4, atol=1e-4)
        # the reference suite's decode tolerance (tests/test_models.py:83-85);
        # the two 1e-4 checks (this forward and test_forward_matches_jax)
        # chain the port's decode to the reference's within about 2e-4
        np.testing.assert_allclose(dec, jax_runs["decode"], rtol=2e-2, atol=2e-2)
        return
    noise = _rel(jax_runs["bfloat16"], jax_runs["float32"])
    assert _rel(dec, full) <= 0.5 * noise, (_rel(dec, full), noise)
    assert (dec.argmax(-1) == full.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mb_index", [0, 1])
def test_loss_and_grads_match_jax_fp32_under_fan_in_h(setup, masked, mb_index):
    """tests/torch_train_common.py's fp32 test under fan-in H (read: every
    leaf within 1.8e-6 relative L2); see the module docstring for the
    reference's init."""
    jarch, arch, params, batch = setup
    params = INITS["fan-in-H"](params, arch)
    mb = {k: v[mb_index] for k, v in batch.items()}
    if masked:
        mb["loss_mask"] = (np.random.default_rng(1).random(mb["labels"].shape) < 0.6) \
            .astype(np.float32)
    jl, jg = _jax_loss_grads(jarch, params, mb, "float32")
    pl, pg = _port_loss_grads(arch, params, mb, "float32")
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert sorted(pg) == sorted(jg)
    tol = FP32_GRAD_TOL["fan-in-H"]
    over = {k: _rel(pg[k], jg[k]) for k in jg if not _rel(pg[k], jg[k]) <= tol}
    assert not over, over
