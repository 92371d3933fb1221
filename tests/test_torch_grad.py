"""The port's kernel backwards on the CPU.

``repro_torch.kernels.ref`` writes the backward of flash attention and of
RMSNorm out by hand (the math of the CUDA backward kernels). Each is held
against autograd of the port's plain forward and against ``jax.vjp`` of
``repro.kernels.ref`` on the same inputs, made with numpy from a seed, at
1e-5 in fp32 (only summation order differs). The autograd Functions
behind ``kernels.flash_attention`` / ``kernels.rmsnorm`` route CPU tensors
to those plain backwards; ``gradcheck`` holds them in fp64, and the
plumbing (GQA, strided [B,S,nh,hd] views, a broadcast gradient, bf16) is
exercised through them. The CUDA kernels are held against the same plain
backwards on the card (tests/test_torch_cuda.py, chip_smoke.py).

The SSD scan's explicit chunked backward (``ref.ssd_scan_bwd_ref``) is
held against autograd of the chunked forward in fp64 (to 1e-9: only
summation order differs), and against ``jax.vjp`` of the JAX package's
sequential oracle (``repro.kernels.ref.ssd_scan_ref``) and of
``repro.models.layers.ssd_scan`` with its state options, in fp32, at the
forward's tolerance (tests/test_kernels.py:55-56, 2e-3) plus relative L2
1e-4 per output (read: at most 4e-6).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models.layers import ssd_scan as jax_layers_ssd_scan  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# the module, which the package's ``ssd_scan`` (the function) shadows
ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")

TOL = dict(rtol=1e-5, atol=1e-5)
# B, S, nh, nkv, hd: GQA groups 1 and 2, S a multiple of nothing used here
FLASH_CASES = [(2, 13, 2, 2, 8), (1, 37, 4, 2, 16), (2, 29, 6, 3, 8)]
MASKS = [(True, 0), (True, 5), (False, 7)]      # causal, causal + window, window alone


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flash_inputs(seed, B, S, nh, nkv, hd):
    rng = np.random.default_rng(seed)
    return (_draw(rng, B, nh, S, hd), _draw(rng, B, nkv, S, hd), _draw(rng, B, nkv, S, hd),
            _draw(rng, B, nh, S, hd))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("B,S,nh,nkv,hd", FLASH_CASES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_ref_matches_autograd_and_jax(B, S, nh, nkv, hd, causal, window):
    q, k, v, do = _flash_inputs(S * 10 + nh, B, S, nh, nkv, hd)
    # explicit backward, given the forward's output
    tq, tk, tv, tdo = _t(q, k, v, do)
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window)
    # autograd of the port's plain forward
    aq, ak, av = _t(q, k, v, grad=True)
    out = ref.flash_attention_ref(aq, ak, av, causal=causal, window=window)
    auto = torch.autograd.grad(out, (aq, ak, av), torch.from_numpy(do))
    # jax.vjp of the reference's plain forward
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL, err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"{name} vs jax")


@pytest.mark.parametrize("B,S,nh,nkv,hd", FLASH_CASES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_fwd_ref_lse_matches_logsumexp_and_jax(B, S, nh, nkv, hd, causal, window):
    """The plain forward's (o, lse): o equal to JAX's reference attention,
    lse the log-sum-exp of the masked scaled scores in log2 units."""
    q, k, v, _ = _flash_inputs(S * 10 + nh + 1, B, S, nh, nkv, hd)
    o, lse = ref.flash_attention_fwd_ref(*_t(q, k, v), causal=causal, window=window)
    want_o = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    kk = np.repeat(k, nh // nkv, axis=1)
    scores = torch.from_numpy(np.einsum("bhqd,bhsd->bhqs", q, kk) * hd ** -0.5)
    mask = ref.attention_mask(S, causal, window, "cpu")
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1) / np.log(2.0)
    assert lse.shape == (B, nh, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want.float(), **TOL)
    torch.testing.assert_close(ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                                       window=window), o, rtol=0, atol=0)


def test_flash_fwd_fully_masked_row_gives_minus_inf_and_zero():
    """A row with no live key (only an explicit mask makes one): lse -inf,
    o 0, every other row as under the causal mask."""
    B, S, nh, nkv, hd = 1, 11, 4, 2, 8
    q, k, v, _ = _t(*_flash_inputs(4, B, S, nh, nkv, hd))
    mask = ref.attention_mask(S, True, 0, "cpu")
    mask[6] = False
    o, lse = ref.flash_fwd_masked(q, k, v, mask)
    assert torch.isneginf(lse[:, :, 6]).all() and (o[:, :, 6] == 0).all()
    o_c, lse_c = ref.flash_attention_fwd_ref(q, k, v, causal=True)
    rows = [i for i in range(S) if i != 6]
    torch.testing.assert_close(o[:, :, rows], o_c[:, :, rows], rtol=0, atol=0)
    torch.testing.assert_close(lse[:, :, rows], lse_c[:, :, rows], rtol=0, atol=0)


@pytest.mark.parametrize("B,S,nh,nkv,hd", FLASH_CASES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_ref_given_the_lse_matches_jax(B, S, nh, nkv, hd, causal, window):
    """The plain backward fed the plain forward's LSE (as the kernels are fed
    the forward kernel's) against ``jax.vjp`` of the reference, and equal to
    the same backward that computes the LSE itself."""
    q, k, v, do = _flash_inputs(S * 10 + nh + 2, B, S, nh, nkv, hd)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    itself = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, itself):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"{name} vs jax")
        torch.testing.assert_close(g, a, rtol=0, atol=0)


@pytest.mark.parametrize("nh,nkv,slices", [(8, 2, 1), (8, 2, 2), (8, 2, 4), (6, 3, 2),
                                           (10, 2, 5), (8, 1, 8)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_slice_partials_sum_to_the_grouped_backward(nh, nkv, slices, causal, window):
    """The wgmma backward's decomposition, modelled in plain PyTorch: the
    kv head's GQA group cut into ``slices`` slices of consecutive query
    heads, each slice's unscaled dK and its dV an fp32 partial, the
    partials summed in slice order and dK scaled after. Equal to the
    grouped plain backward within fp32 rounding."""
    B, S, hd = 2, 23, 8
    q, k, v, do = _t(*_flash_inputs(nh * 10 + slices, B, S, nh, nkv, hd))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    _, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    group = nh // nkv
    per = group // slices
    dk_sum, dv_sum = torch.zeros_like(k), torch.zeros_like(v)
    for s in range(slices):
        heads = [hk * group + s * per + i for hk in range(nkv) for i in range(per)]
        pick = lambda t: t[:, heads].contiguous()
        _, dk_s, dv_s = ref.flash_attention_bwd_ref(pick(q), k, v, pick(o), pick(do),
                                                    pick(lse), causal=causal, window=window)
        dk_sum += dk_s / hd ** -0.5       # the partial is unscaled
        dv_sum += dv_s
    torch.testing.assert_close(dk_sum * hd ** -0.5, dk, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-6, atol=1e-6)


def test_flash_function_saves_the_forwards_lse_only_for_a_gradient():
    """``kernels.flash_attention`` asks the forward for the LSE only when a
    gradient will be taken, and its backward reads that LSE: the result
    equals the plain backward given the plain forward's LSE."""
    B, S, nh, nkv, hd = 1, 17, 4, 2, 8
    q, k, v, do = _t(*_flash_inputs(9, B, S, nh, nkv, hd))
    with torch.no_grad():
        assert kernels.flash_attention(q, k, v).grad_fn is None
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = kernels.flash_attention(qg, kg, vg, window=5)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (B, nh, S)
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    _, lse = ref.flash_attention_fwd_ref(q, k, v, window=5)
    torch.testing.assert_close(saved[4], lse, rtol=0, atol=0)
    want = ref.flash_attention_bwd_ref(q, k, v, o.detach(), do, lse, window=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_flash_bwd_fully_masked_row_gives_zero():
    """The public masks always keep the diagonal, so no row is ever empty
    there; an empty row of an explicit mask has LSE -inf, and every entry
    is masked before the exp: dq of the row is 0, and dk, dv are those of
    the same call with the row's gradient zeroed, all finite."""
    B, S, nh, nkv, hd = 1, 11, 4, 2, 8
    q, k, v, do = _t(*_flash_inputs(3, B, S, nh, nkv, hd))
    mask = ref.attention_mask(S, True, 0, "cpu")
    mask[4] = False
    o = ref.flash_attention_ref(q, k, v, causal=True)
    o[:, :, 4] = 0.0
    dq, dk, dv = ref.flash_bwd_masked(q, k, v, o, do, mask)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, :, 4] == 0).all()
    do0 = do.clone()
    do0[:, :, 4] = 0.0
    _, dk0, dv0 = ref.flash_bwd_masked(q, k, v, o, do0, mask)
    torch.testing.assert_close(dk, dk0, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv0, rtol=0, atol=0)


@pytest.mark.parametrize("T,H", [(1, 8), (5, 24), (33, 64)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax(T, H):
    rng = np.random.default_rng(T * 100 + H)
    x, w, dy = _draw(rng, T, H), _draw(rng, H), _draw(rng, T, H)
    got = ref.rmsnorm_bwd_ref(*_t(x, w, dy))
    ax, aw = _t(x, w, grad=True)
    auto = torch.autograd.grad(ref.rmsnorm_ref(ax, aw), (ax, aw), torch.from_numpy(dy))
    _, vjp = jax.vjp(jax_rmsnorm_ref, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    for name, g, a, wj in zip(("dx", "dw"), got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL, err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **TOL, err_msg=f"{name} vs jax")


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2)])
def test_flash_function_gradcheck_fp64(causal, window, nh, nkv):
    rng = np.random.default_rng(nh)
    q = torch.from_numpy(rng.standard_normal((1, nh, 9, 4))).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, nkv, 9, 4))).requires_grad_()
            for _ in range(2))
    fn = lambda a, b, c: kernels.flash_attention(a, b, c, causal=causal, window=window)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_rmsnorm_function_gradcheck_fp64():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 16))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(16)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: kernels.rmsnorm(a, b), (x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_takes_strided_views_and_broadcast_grads(dtype):
    """The model's path: [B,S,nh,hd] tensors as [B,nh,S,hd] views, a
    gradient that is a broadcast (stride 0, as from ``.sum()``), the
    result's gradients in the inputs' types and layouts. Equal to the
    explicit backward on dense copies."""
    B, S, nh, nkv, hd = 2, 19, 4, 2, 8
    rng = np.random.default_rng(5)
    mk = lambda n: torch.from_numpy(_draw(rng, B, S, n, hd)).to(dtype).requires_grad_()
    q, k, v = mk(nh), mk(nkv), mk(nkv)
    o = kernels.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=True, window=6)
    assert o.grad_fn is not None and o.dtype == dtype
    dq, dk, dv = torch.autograd.grad(o.float().sum(), (q, k, v))
    qd, kd, vd = (t.detach().transpose(1, 2).contiguous() for t in (q, k, v))
    want = ref.flash_attention_bwd_ref(qd, kd, vd, o.detach().contiguous(), torch.ones_like(qd),
                                       causal=True, window=6)
    for g, w, t in zip((dq, dk, dv), want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        torch.testing.assert_close(g, w.transpose(1, 2), rtol=0, atol=0)


def test_rmsnorm_function_routes_to_the_explicit_backward():
    """Through ``kernels.rmsnorm`` a CPU tensor's backward is exactly
    ``ref.rmsnorm_bwd_ref`` (bf16 in, bf16 dx and dw out), with a
    non-contiguous incoming gradient."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_draw(rng, 7, 32)).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(_draw(rng, 32)).to(torch.bfloat16).requires_grad_()
    dy = torch.from_numpy(_draw(rng, 32, 7)).to(torch.bfloat16).t()
    y = kernels.rmsnorm(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    want = ref.rmsnorm_bwd_ref(x.detach(), w.detach(), dy.contiguous())
    torch.testing.assert_close(dx, want[0], rtol=0, atol=0)
    torch.testing.assert_close(dw, want[1], rtol=0, atol=0)
    assert dx.dtype == dw.dtype == torch.bfloat16


def test_backward_wrappers_count_no_cpu_launches():
    kernels.reset_launch_counts()
    x = torch.ones(3, 8, requires_grad=True)
    kernels.rmsnorm(x, torch.ones(8)).sum().backward()
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


# ---------------------------------------------------------------- SSD scan

SSD_TOL = dict(rtol=2e-3, atol=2e-3)    # tests/test_kernels.py:55-56
SSD_REL_L2 = 1e-4
SSD_PARTS = ("dx", "ddt", "dA", "dBm", "dCm")


def _ssd_inputs(seed, B, nh, S, hp, N, long_memory=False):
    """x [B,nh,S,hp], dt [B,nh,S], A [nh], Bm/Cm [B,S,N], dy like x, fp32
    numpy. The tests' draw (dt = softplus(N(0,1)), A = -exp(N(0,1)/2))
    forgets within a few tokens; ``long_memory`` draws from the init's
    ranges (dt ~ U(1e-3, 1e-1), A = -U(1, 16)), so the state carried
    across chunks matters."""
    rng = np.random.default_rng(seed)
    x = _draw(rng, B, nh, S, hp)
    if long_memory:
        dt = rng.uniform(1e-3, 1e-1, (B, nh, S)).astype(np.float32)
        A = -rng.uniform(1.0, 16.0, nh).astype(np.float32)
    else:
        dt = np.logaddexp(rng.standard_normal((B, nh, S)), 0).astype(np.float32)
        A = -np.exp(0.5 * rng.standard_normal(nh)).astype(np.float32)
    return x, dt, A, _draw(rng, B, S, N), _draw(rng, B, S, N), _draw(rng, B, nh, S, hp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("hp", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 300])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_ref_matches_autograd_fp64(hp, N, S, long_memory):
    """The explicit backward against autograd of the chunked forward, fp64,
    with an initial state and a gradient of the final state; chunk 64, so
    S 63, 65 and 300 end in a padded tail and S 1 is one token."""
    x, dt, A, Bm, Cm, dy = _ssd_inputs(S * 7 + hp + N, 2, 2, S, hp, N, long_memory)
    rng = np.random.default_rng(S + N)
    h0, d_final = (rng.standard_normal((2, 2, hp, N)) for _ in range(2))
    args = [torch.from_numpy(a).double() for a in (x, dt, A, Bm, Cm, h0)]
    leaves = [a.clone().requires_grad_() for a in args]
    y, h = ref.ssd_scan_ref(*leaves[:5], chunk=64, initial_state=leaves[5], return_state=True)
    loss = (y * torch.from_numpy(dy).double()).sum() + (h * torch.from_numpy(d_final)).sum()
    auto = torch.autograd.grad(loss, leaves)
    got = ref.ssd_scan_bwd_ref(*args[:5], torch.from_numpy(dy).double(), args[5],
                               torch.from_numpy(d_final), chunk=64)
    for name, g, a in zip(SSD_PARTS + ("d_initial",), got, auto):
        assert g.dtype == torch.float64 and g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("B,nh,S,hp,N", [(1, 2, 300, 32, 64), (2, 2, 65, 64, 128),
                                         (1, 2, 63, 16, 16), (1, 3, 1, 16, 32),
                                         (1, 2, 130, 64, 16)])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_ref_matches_jax_oracle(B, nh, S, hp, N, long_memory):
    """fp32: the explicit backward (chunk 256) against ``jax.vjp`` of the
    JAX package's token-by-token oracle."""
    x, dt, A, Bm, Cm, dy = _ssd_inputs(S + hp, B, nh, S, hp, N, long_memory)
    got = ref.ssd_scan_bwd_ref(*_t(x, dt, A, Bm, Cm, dy))
    _, vjp = jax.vjp(jax_ssd_ref, *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    want = vjp(jnp.asarray(dy))
    for name, g, w in zip(SSD_PARTS, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **SSD_TOL, err_msg=name)
        assert _rel(g.numpy(), w) <= SSD_REL_L2 or not np.abs(w).max(), name


@pytest.mark.parametrize("B,nh,S,hp,N,chunk", [(2, 3, 300, 32, 64, 64), (1, 2, 100, 16, 32, 256),
                                               (1, 2, 130, 64, 128, 64)])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_ref_matches_jax_layers_with_state(B, nh, S, hp, N, chunk, long_memory):
    """fp32: through ``SSDScan`` in ``repro_torch.models.layers.ssd_scan``
    ([B,S,nh,hp] layout, initial_state, return_state) against ``jax.vjp``
    of ``repro.models.layers.ssd_scan`` on the same inputs, a gradient on
    y and on the final state."""
    x, dt, A, Bm, Cm, dy = _ssd_inputs(S + N, B, nh, S, hp, N, long_memory)
    rng = np.random.default_rng(hp)
    h0, d_final = (rng.standard_normal((B, nh, hp, N)).astype(np.float32) for _ in range(2))
    xs, dts, dys = (np.ascontiguousarray(a.swapaxes(1, 2)) for a in (x, dt, dy))
    f = lambda *a: jax_layers_ssd_scan(*a[:5], chunk=chunk, initial_state=a[5], return_state=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (xs, dts, A, Bm, Cm, h0)))
    want = vjp((jnp.asarray(dys), jnp.asarray(d_final)))
    from repro_torch.models.layers import ssd_scan as layers_ssd_scan
    leaves = _t(xs, dts, A, Bm, Cm, h0, grad=True)
    y, h = layers_ssd_scan(*leaves[:5], chunk, initial_state=leaves[5], return_state=True)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dys), torch.from_numpy(d_final)))
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm", "d_initial"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **SSD_TOL, err_msg=name)
        assert _rel(g.numpy(), w) <= SSD_REL_L2, name


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S,chunk", [(1, 64), (13, 4), (20, 8)])
def test_ssd_function_gradcheck_fp64(state, S, chunk):
    """gradcheck through ``kernels.ssd_scan`` (``SSDScan``), fp64, in every
    input, with and without an initial state and the final state; S 13 and
    20 span several chunks and end in a padded tail."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(S, 1, 1, S, 16, 16)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    if state:
        h0 = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1, 16, 16)))
        fn = lambda *a: kernels.ssd_scan(*a[:5], chunk=chunk, initial_state=a[5],
                                         return_state=True)
        leaves.append(h0.requires_grad_())
    else:
        fn = lambda *a: kernels.ssd_scan(*a, chunk=chunk)
    assert torch.autograd.gradcheck(fn, tuple(leaves))


@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_does_not_depend_on_the_chunk(long_memory):
    """In exact arithmetic the backward does not depend on the chunk length
    (the CUDA kernel blocks by 64, the plain version by 256): chunks 32, 64
    and 256 agree in fp64 to 1e-10 and in fp32 within relative L2 1e-4."""
    x, dt, A, Bm, Cm, dy = _ssd_inputs(11, 2, 3, 300, 32, 64, long_memory)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, SSD_REL_L2)):
        args = [torch.from_numpy(a).to(dtype) for a in (x, dt, A, Bm, Cm, dy)]
        base = ref.ssd_scan_bwd_ref(*args, chunk=256)
        for chunk in (32, 64):
            other = ref.ssd_scan_bwd_ref(*args, chunk=chunk)
            for name, g, w in zip(SSD_PARTS + ("d_initial",), other, base):
                assert _rel(g.numpy(), w.numpy()) <= tol, (dtype, chunk, name)


def test_ssd_function_routes_to_the_explicit_backward():
    """Through ``kernels.ssd_scan`` a CPU tensor's backward is exactly
    ``ref.ssd_scan_bwd_ref``: the model's strided views (x, Bm, Cm slices
    of one buffer, dt a [B,nh,S] view), a broadcast incoming gradient,
    bf16 gradients in the inputs' types, and no kernel launch counted."""
    B, nh, S, hp, N = 1, 2, 70, 16, 16
    x, dt, A, Bm, Cm, _ = _ssd_inputs(4, B, nh, S, hp, N)
    buf = torch.from_numpy(np.concatenate([x.transpose(0, 2, 1, 3).reshape(B, S, nh * hp), Bm, Cm],
                                          axis=-1)).to(torch.bfloat16).requires_grad_()
    dtl = torch.from_numpy(dt.transpose(0, 2, 1).copy()).requires_grad_()
    Al = torch.from_numpy(A).requires_grad_()
    xv = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    bv, cv = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    kernels.reset_launch_counts()
    y = kernels.ssd_scan(xv, dtl.transpose(1, 2), Al, bv, cv, chunk=32)
    assert y.grad_fn is not None and y.dtype == torch.bfloat16
    dbuf, ddt, dA = torch.autograd.grad(y.float().sum(), (buf, dtl, Al))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    want = ref.ssd_scan_bwd_ref(xv.detach(), dtl.detach().transpose(1, 2), Al.detach(),
                                bv.detach(), cv.detach(), torch.ones_like(xv), chunk=32)
    assert dbuf.dtype == torch.bfloat16 and ddt.dtype == dA.dtype == torch.float32
    got_x = dbuf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    torch.testing.assert_close(got_x, want[0], rtol=0, atol=0)
    torch.testing.assert_close(ddt.transpose(1, 2), want[1], rtol=0, atol=0)
    torch.testing.assert_close(dA, want[2], rtol=0, atol=0)
    torch.testing.assert_close(dbuf[..., nh * hp:nh * hp + N], want[3], rtol=0, atol=0)
    torch.testing.assert_close(dbuf[..., nh * hp + N:], want[4], rtol=0, atol=0)


def _ssd_bwd_args(hp=64, N=128, dtype=torch.bfloat16, B=2, nh=3, S=40):
    x = torch.zeros(B, nh, S, hp, dtype=dtype)
    return (x, torch.zeros(B, nh, S), -torch.ones(nh), torch.zeros(B, S, N, dtype=dtype),
            torch.zeros(B, S, N, dtype=dtype), torch.zeros_like(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hp", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
def test_ssd_bwd_kernel_takes_every_forward_shape(dtype, hp, N):
    """One backward kernel serves every (dtype, hp, N) the forward kernels
    take, with the state options on every path."""
    assert ssd_module.bwd_kernel_path(dtype, hp, N) == "fma"
    args = _ssd_bwd_args(hp, N, dtype)
    state = torch.zeros(2, 3, hp, N)
    assert ssd_module.check_bwd_args(*args, state, state) == "fma"


def test_ssd_bwd_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="instantiated"):
        ssd_module.bwd_kernel_path(torch.bfloat16, 48, 128)
    with pytest.raises(ValueError, match="instantiated"):
        ssd_module.bwd_kernel_path(torch.float32, 64, 256)
    with pytest.raises(TypeError):
        ssd_module.bwd_kernel_path(torch.float16, 64, 128)
    x, dt, A, Bm, Cm, dy = _ssd_bwd_args()
    with pytest.raises(ValueError, match="instantiated"):
        ssd_module.check_bwd_args(*_ssd_bwd_args(hp=128))
    with pytest.raises(ValueError, match="dy must be"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, dy.float())
    with pytest.raises(ValueError, match="dy must be"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, dy[:, :, :-1])
    with pytest.raises(TypeError, match="float32"):
        ssd_module.check_bwd_args(x, dt.double(), A, Bm, Cm, dy)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, dy, torch.zeros(2, 3, 128, 64))
    with pytest.raises(ValueError, match="d_final"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, dy, None,
                                  torch.zeros(2, 3, 64, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unit last stride"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, dy.transpose(-1, -2).contiguous()
                                  .transpose(-1, -2))
    off = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        ssd_module.check_bwd_args(x, dt, A, Bm, Cm, off)


def test_ssd_bwd_counts_no_cpu_launch():
    kernels.reset_launch_counts()
    out = ssd_module.ssd_scan_bwd(*(t.float() if t.is_floating_point() else t
                                    for t in _ssd_bwd_args(hp=16, N=16)))
    assert len(out) == 6 and all(torch.isfinite(t).all() for t in out)
    x = torch.ones(1, 2, 8, 16, requires_grad=True)
    kernels.ssd_scan(x, torch.ones(1, 2, 8), -torch.ones(2), torch.ones(1, 8, 16),
                     torch.ones(1, 8, 16)).sum().backward()
    assert x.grad is not None
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
