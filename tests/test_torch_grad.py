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
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
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


def test_ssd_scan_refuses_grad_on_cuda(monkeypatch):
    """On CUDA tensors there is no SSD backward kernel: with grad mode on
    and an input that requires grad, ``kernels.ssd_scan`` raises before any
    launch, instead of returning a y with no grad_fn. The device check is
    patched so that CPU tensors take the CUDA branch."""
    monkeypatch.setattr(ssd_module, "_device_type", lambda t: "cuda")
    B, nh, S, hp, N = 1, 2, 8, 16, 16
    x = torch.zeros(B, nh, S, hp, dtype=torch.bfloat16, requires_grad=True)
    args = (torch.zeros(B, nh, S), -torch.ones(nh), torch.zeros(B, S, N, dtype=torch.bfloat16),
            torch.zeros(B, S, N, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="SSD backward not ported"):
        kernels.ssd_scan(x, *args)
    A = -torch.ones(nh, requires_grad=True)
    with pytest.raises(RuntimeError, match="SSD backward not ported"):
        kernels.ssd_scan(x.detach(), args[0], A, *args[2:])
