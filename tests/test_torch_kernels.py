"""The port's kernels against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions
(``repro_torch.kernels.ref``); those are held against the Pallas kernels
in interpret mode and against ``repro.kernels.ref`` on the same inputs,
made with numpy from a seed, over the grid and tolerances of
tests/test_kernels.py. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash, rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels import ssd_scan as jax_ssd  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models.layers import ssd_scan as jax_layers_ssd_scan  # noqa: E402
from repro.models.layers import ssm_decode_step as jax_ssm_decode_step  # noqa: E402
from repro_torch import kernels, resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref, ssd_scan_ref  # noqa: E402
from repro_torch.models.layers import softplus, ssm_decode_step  # noqa: E402
from repro_torch.models.layers import ssd_scan as layers_ssd_scan  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_GRID = [
    (1, 128, 4, 4, 64),     # MHA, exact tile multiple
    (2, 200, 4, 2, 64),     # GQA, padded tail
    (1, 384, 8, 1, 32),     # MQA, hd below lane width
    (2, 256, 6, 3, 128),    # grouped, 128-wide heads
    (1, 200, 12, 1, 192),   # nemotron-4-340b's hd 192 and GQA group 12, padded tail
]
RMS_GRID = [(64, 256), (100, 512), (256, 1024)]
SSD_GRID = [                    # B, nh, S, hp, N, chunk (tests/test_kernels.py:40-44)
    (1, 2, 256, 64, 16, 128),
    (2, 3, 300, 32, 64, 64),    # padded tail
    (1, 4, 64, 16, 128, 32),
]


def _tol(dtype):
    # tests/test_kernels.py:16-18
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=3e-4, atol=3e-4)


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_inputs(seed, B, S, nh, nkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, nh, S, hd), (B, nkv, S, hd), (B, nkv, S, hd))]
    pairs = [_both(a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,S,nh,nkv,hd", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_attention_matches_pallas_and_ref(B, S, nh, nkv, hd, dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(7, B, S, nh, nkv, hd, dtype)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    jref = jax_flash_ref(jq, jk, jv, causal=True, window=window)
    out = flash_attention(tq, tk, tv, causal=True, window=window)   # CPU: plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jref), **_tol(dtype))


# non-causal attention (hubert-xlarge's encoder): its head_dim 80 with S
# past the 128-row tiles, and the grid's head dims
NONCAUSAL_GRID = [
    (2, 200, 4, 4, 80),     # hubert's hd, a tail of 72 rows
    (1, 130, 2, 2, 80),     # a tail of 2 rows
    (2, 256, 6, 3, 128),
    (1, 128, 4, 2, 64),
    (1, 200, 12, 1, 192),   # nemotron-4-340b's hd 192, a tail of 72 rows
]


@pytest.mark.parametrize("B,S,nh,nkv,hd", NONCAUSAL_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_noncausal_matches_pallas_and_ref(B, S, nh, nkv, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(9, B, S, nh, nkv, hd, dtype)
    pallas = jax_flash(jq, jk, jv, causal=False, interpret=True)
    jref = jax_flash_ref(jq, jk, jv, causal=False)
    out = flash_attention(tq, tk, tv, causal=False)                  # CPU: plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jref), **_tol(dtype))


def test_flash_attention_noncausal_backward_at_hd80_matches_jax():
    """The plain backward of non-causal attention at hubert's head_dim 80
    and a tail S (fed the plain forward's LSE, as the kernels are fed the
    forward kernel's) against ``jax.vjp`` of the reference, fp32 at the
    grid's 3e-4."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_fwd_ref
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(4, 1, 130, 4, 4, 80, "float32")
    do = np.random.default_rng(6).standard_normal(tq.shape, dtype=np.float32)
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal=False)
    got = flash_attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(do), lse, causal=False)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=False), jq, jk, jv)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(g), _np(w), **_tol("float32"))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_at_hd192_matches_jax(causal):
    """The plain backward at nemotron-4-340b's head_dim 192 and GQA group
    12, a tail S, causal and not (fed the plain forward's LSE, as the
    kernels are fed the forward kernel's) against ``jax.vjp`` of the
    reference, fp32 at the grid's 3e-4."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_fwd_ref
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(8, 1, 130, 12, 1, 192, "float32")
    do = np.random.default_rng(10).standard_normal(tq.shape, dtype=np.float32)
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(do), lse, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal), jq, jk, jv)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(g), _np(w), **_tol("float32"))


def test_flash_attention_model_layout_views():
    """[B,nh,S,hd] views of [B,S,nh,hd] tensors (the model's layout) give
    what contiguous tensors give."""
    (_, _, _), (q, k, v) = _flash_inputs(3, 2, 200, 4, 2, 64, "float32")
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    np.testing.assert_array_equal(_np(flash_attention(*views)), _np(flash_attention_ref(q, k, v)))


def test_flash_attention_fully_masked_rows_are_zero():
    """Window smaller than the pad tail (tests/test_kernels.py:95-103): the
    kernel's padded rows see no key; the rows it returns stay finite and
    match the plain version."""
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(5, 1, 130, 2, 2, 64, "float32")
    pallas = jax_flash(jq, jk, jv, causal=True, window=3, interpret=True)
    out = flash_attention(tq, tk, tv, causal=True, window=3)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol("float32"))


@pytest.mark.parametrize("T,H", RMS_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_and_ref(T, H, dtype):
    rng = np.random.default_rng(11)
    jx, tx = _both(rng.standard_normal((T, H), dtype=np.float32), dtype)
    jw, tw = _both(rng.standard_normal((H,), dtype=np.float32), dtype)
    pallas = jax_rmsnorm(jx, jw, interpret=True)
    out = rmsnorm(tx, tw)                                             # CPU: plain version
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jax_rmsnorm_ref(jx, jw)), **_tol(dtype))
    np.testing.assert_array_equal(_np(out), _np(rmsnorm_ref(tx, tw)))


def _ssd_inputs(seed, B, nh, S, hp, N, long_memory=False):
    """numpy inputs. tests/test_kernels.py's draw (dt = softplus(N(0,1)),
    A = -exp(N(0,1)/2)) forgets within a few tokens; ``long_memory`` draws
    from the init's ranges (dt ~ U(1e-3, 1e-1), A = -U(1, 16)), so the
    state carried across chunks matters far past a chunk start."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nh, S, hp), dtype=np.float32)
    if long_memory:
        dt = rng.uniform(1e-3, 1e-1, (B, nh, S)).astype(np.float32)
        A = -rng.uniform(1.0, 16.0, nh).astype(np.float32)
    else:
        dt = np.logaddexp(rng.standard_normal((B, nh, S)), 0).astype(np.float32)
        A = -np.exp(0.5 * rng.standard_normal(nh)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,nh,S,hp,N,chunk", SSD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas_and_ref(B, nh, S, hp, N, chunk, dtype):
    """The plain version against the Pallas kernel in interpret mode and the
    JAX recurrence, at tests/test_kernels.py:55-56's tolerances."""
    x, dt, A, Bm, Cm = _ssd_inputs(7, B, nh, S, hp, N)
    (jx, tx), (jb, tb), (jc, tc) = _both(x, dtype), _both(Bm, dtype), _both(Cm, dtype)
    jdt, jA = jnp.asarray(dt), jnp.asarray(A)
    pallas = jax_ssd(jx, jdt, jA, jb, jc, chunk=chunk, interpret=True)
    jref = jax_ssd_ref(jx, jdt, jA, jb, jc)
    out = ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc, chunk=chunk)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(out), _np(pallas), **tol)
    np.testing.assert_allclose(_np(out), _np(jref), **tol)


def test_ssd_scan_model_layout_views():
    """The model's layout: x a [B,nh,S,hp] view of a column slice of the
    conv output [B,S,conv_dim], Bm and Cm column slices of it, dt a
    [B,nh,S] view of a [B,S,nh] tensor. The same values as dense tensors."""
    B, nh, S, hp, N = 2, 3, 300, 32, 16
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(3, B, nh, S, hp, N))
    buf = torch.cat([x.transpose(1, 2).reshape(B, S, nh * hp), Bm, Cm], dim=-1)
    xv = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    bv, cv = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    dtv = dt.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (xv.is_contiguous() or bv.is_contiguous() or dtv.is_contiguous())
    np.testing.assert_array_equal(_np(ssd_scan(xv, dtv, A, bv, cv, chunk=64)),
                                  _np(ssd_scan_ref(x, dt, A, Bm, Cm, chunk=64)))


@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_plain_version_equals_decode_recurrence(long_memory):
    """The chunked plain version equals the token-by-token recurrence that
    decode runs (the port's ``ssm_decode_step``, itself held to JAX's):
    tests/test_kernels.py:61-80, plus a long-memory draw over several
    chunks."""
    B, nh, S, hp, N = 1, 2, 96, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(5, B, nh, S, hp, N, long_memory)
    out = ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=32)
    state = torch.zeros(B, nh, hp, N)
    jstate = jnp.zeros((B, nh, hp, N))
    ys = []
    for t in range(S):
        args = (x[:, :, t], dt[:, :, t], A, Bm[:, t], Cm[:, t])
        y, state = ssm_decode_step(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                                   state)
        jy, jstate = jax_ssm_decode_step(*(jnp.asarray(a) for a in args), jstate)
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(_np(out), _np(torch.stack(ys, dim=2)), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_plain_version_computes_in_fp64_for_fp64(long_memory):
    """fp64 inputs: the chunked plain version, through ``kernels.ssd_scan``
    and ``layers.ssd_scan`` (initial state and final state too), equals an
    fp64 token-by-token loop of ``ssm_decode_step`` to 1e-12, and returns
    fp64; an fp32 computation would sit ~1e-6 away."""
    B, nh, S, hp, N = 1, 2, 96, 16, 32
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in _ssd_inputs(5, B, nh, S, hp, N,
                                                                  long_memory))
    h0 = np.random.default_rng(6).standard_normal((B, nh, hp, N))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    state, ys = t(h0), []
    for s in range(S):
        y, state = ssm_decode_step(t(x[:, :, s]), t(dt[:, :, s]), t(A), t(Bm[:, s]), t(Cm[:, s]),
                                   state)
        ys.append(y)
    want, want_h = torch.stack(ys, dim=2), state
    assert want.dtype == torch.float64
    out = ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk=32)
    y, h = layers_ssd_scan(t(x.transpose(0, 2, 1, 3)), t(dt.transpose(0, 2, 1)), t(A), t(Bm),
                           t(Cm), 32, initial_state=t(h0), return_state=True)
    y0 = ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk=32, initial_state=t(h0))
    for got, ref_ in ((y0, want), (y.transpose(1, 2), want), (h, want_h)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref_.numpy(), rtol=1e-12, atol=1e-12)
    # from a zero state
    state, ys = torch.zeros(B, nh, hp, N, dtype=torch.float64), []
    for s in range(S):
        yy, state = ssm_decode_step(t(x[:, :, s]), t(dt[:, :, s]), t(A), t(Bm[:, s]), t(Cm[:, s]),
                                    state)
        ys.append(yy)
    np.testing.assert_allclose(out.numpy(), torch.stack(ys, dim=2).numpy(), rtol=1e-12,
                               atol=1e-12)


def _ssd_scan_ref_as_it_stood(x, dt, A, Bm, Cm, *, chunk=256, initial_state=None,
                              return_state=False):
    """``ref.ssd_scan_ref`` before it computed in fp64 for fp64 inputs: fp32
    whatever the input type. Kept verbatim to hold fp32 and bf16 to it."""
    import torch.nn.functional as F
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, pad)).reshape(B, nh, nc, Q, hp)
    dtc = F.pad(dt.to(f32), (0, pad)).reshape(B, nh, nc, Q)
    Bc = F.pad(Bm.to(f32), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.to(f32), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    acs = torch.cumsum(dtc * A.to(f32)[None, :, None, None], dim=-1)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    scores = cb[:, None] * decay * dtc[..., None, :]
    y = torch.einsum("bhcij,bhcjp->bhcip", scores, xc)
    del decay, scores
    w = torch.exp(acs[..., -1:] - acs) * dtc
    states = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], Bc)
    chunk_decay = torch.exp(acs[..., -1])
    h = (torch.zeros(B, nh, hp, N, dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    h_prev = torch.stack(entering, dim=2)
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cc, h_prev) * torch.exp(acs)[..., None]
    y = y.reshape(B, nh, nc * Q, hp)[:, :, :S].to(x.dtype)
    return (y, h) if return_state else y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_plain_version_fp32_and_bf16_bits_unchanged(dtype, long_memory):
    """The fp64 repair leaves fp32 and bf16 as they were, bit for bit: y
    and the final state of ``kernels.ssd_scan`` and ``layers.ssd_scan``
    (which took dt, A and the state in fp32 and still does for these types)
    equal the fp32 path as it stood."""
    B, nh, S, hp, N = 2, 3, 300, 32, 64
    x, dt, A, Bm, Cm = _ssd_inputs(9, B, nh, S, hp, N, long_memory)
    td = DTYPES[dtype][1]
    tx, tb, tc = (torch.from_numpy(a).to(td) for a in (x, Bm, Cm))
    tdt, tA = torch.from_numpy(dt), torch.from_numpy(A)
    h0 = torch.from_numpy(np.random.default_rng(2).standard_normal((B, nh, hp, N),
                                                                   dtype=np.float32))
    old = _ssd_scan_ref_as_it_stood(tx, tdt, tA, tb, tc, chunk=64, initial_state=h0,
                                    return_state=True)
    new = ssd_scan(tx, tdt, tA, tb, tc, chunk=64, initial_state=h0, return_state=True)
    lay = layers_ssd_scan(tx.transpose(1, 2), tdt.transpose(1, 2), tA, tb, tc, 64,
                          initial_state=h0, return_state=True)
    for got in (new, (lay[0].transpose(1, 2), lay[1])):
        assert got[0].dtype == td and got[1].dtype == torch.float32
        assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    assert torch.equal(ssd_scan(tx, tdt, tA, tb, tc, chunk=64),
                       _ssd_scan_ref_as_it_stood(tx, tdt, tA, tb, tc, chunk=64))


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# B, nh, S, hp, N, chunk: a padded tail over several chunks, S shorter
# than one chunk, and mamba2's hp 64 / N 128 and hymba-1.5b's hp 64 / N 16
# at a narrow head count with a padded tail
SSD_STATE_GRID = [(2, 3, 300, 32, 64, 64), (1, 2, 100, 16, 32, 256), (1, 2, 130, 64, 128, 64),
                  (1, 2, 130, 64, 16, 64)]


@pytest.mark.parametrize("B,nh,S,hp,N,chunk", SSD_STATE_GRID)
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_scan_initial_and_final_state_match_jax(B, nh, S, hp, N, chunk, long_memory):
    """``layers.ssd_scan(..., initial_state=..., return_state=True)`` in the
    port and in JAX on the same numpy inputs, fp32: y and the final state
    within tests/test_kernels.py:56's 2e-3 and relative L2 1e-4."""
    x, dt, A, Bm, Cm = _ssd_inputs(13, B, nh, S, hp, N, long_memory)
    h0 = np.random.default_rng(17).standard_normal((B, nh, hp, N), dtype=np.float32)
    xs, dts = np.ascontiguousarray(x.transpose(0, 2, 1, 3)), np.ascontiguousarray(dt.transpose(0, 2, 1))
    jy, jh = jax_layers_ssd_scan(*(jnp.asarray(a) for a in (xs, dts, A, Bm, Cm)), chunk=chunk,
                                 initial_state=jnp.asarray(h0), return_state=True)
    y, h = layers_ssd_scan(*(torch.from_numpy(a) for a in (xs, dts, A, Bm, Cm)), chunk,
                           initial_state=torch.from_numpy(h0), return_state=True)
    assert y.shape == xs.shape and h.shape == (B, nh, hp, N) and h.dtype == torch.float32
    for got, want in ((y, jy), (h, jh)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)
        assert _rel_l2(got, want) <= 1e-4
    # without the options: the plain y, and a zero initial state gives it too
    y0 = layers_ssd_scan(*(torch.from_numpy(a) for a in (xs, dts, A, Bm, Cm)), chunk)
    y1, _ = layers_ssd_scan(*(torch.from_numpy(a) for a in (xs, dts, A, Bm, Cm)), chunk,
                            initial_state=torch.zeros(B, nh, hp, N), return_state=True)
    np.testing.assert_array_equal(_np(y0), _np(y1))


# segment boundaries (in tokens) of S: whole 64-token chunks with a short
# last segment, a cut inside a chunk, and S shorter than one chunk
SSD_SPLITS = [(300, (0, 128, 256, 300)), (300, (0, 64, 100, 300)), (40, (0, 40)),
              (200, (0, 64, 128, 192, 200))]


@pytest.mark.parametrize("S,cuts", SSD_SPLITS)
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_scan_decomposes_into_segments(S, cuts, long_memory):
    """What the CUDA kernel's split of S rests on, in fp32 on the plain
    version: (a) segment by segment with the state carried across equals
    one call over S; (b) the state entering a segment equals the fold of
    the earlier segments' end states, each computed from a zero state:
    h <- exp(A sum dt over the segment) h + E_s, from the initial state."""
    B, nh, hp, N = 1, 3, 32, 64
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(19, B, nh, S, hp, N, long_memory))
    h0 = torch.from_numpy(np.random.default_rng(23).standard_normal((B, nh, hp, N),
                                                                    dtype=np.float32))
    y_all, h_all = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=64, initial_state=h0, return_state=True)
    ys, h, fold = [], h0, h0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        seg = (x[:, :, lo:hi], dt[:, :, lo:hi], A, Bm[:, lo:hi], Cm[:, lo:hi])
        np.testing.assert_allclose(_np(fold), _np(h), rtol=1e-4, atol=1e-4)
        y, h = ssd_scan_ref(*seg, chunk=64, initial_state=h, return_state=True)
        _, end = ssd_scan_ref(*seg, chunk=64, return_state=True)
        fold = fold * torch.exp(A[None, :, None, None] * dt[:, :, lo:hi].sum(-1)[..., None, None]) + end
        ys.append(y)
    y = torch.cat(ys, dim=2)
    for got, want in ((y, y_all), (h, h_all), (fold, h_all)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
        assert _rel_l2(got, want) <= 1e-5


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-100, 100, 2001), [0.0, 1e-8, -1e-8, 30.0, 88.0]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(_np(softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_cpu_calls_launch_no_kernel():
    kernels.reset_launch_counts()
    (_, _, _), (q, k, v) = _flash_inputs(1, 1, 64, 2, 1, 32, "float32")
    flash_attention(q, k, v)
    rmsnorm(torch.ones(4, 8), torch.ones(8))
    ssd_scan(*(torch.from_numpy(a) for a in _ssd_inputs(1, 1, 2, 40, 16, 16)))
    assert kernels.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                       "rmsnorm": 0, "rmsnorm_bwd": 0, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0}


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, asking for CUDA raises. A tensor without storage
    (the meta device) takes the CUDA path's checks and allocations, never
    the plain version: what the kernels refuse raises (where the plain
    version would run), the LSE comes in the kernels' padded rows, and
    nothing launches."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    kernels.reset_launch_counts()
    meta = torch.empty(2, 4, 64, 32, device="meta")
    o, lse = flash_attention_fwd(meta, meta[:, :2], meta[:, :2])
    assert o.device.type == "meta" and o.shape == meta.shape
    assert lse.shape == (2, 4, 64) and lse.stride() == (4 * 128, 128, 1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.empty(1, 2, 8, 48, device="meta") for _ in range(3)))
    assert rmsnorm(torch.empty(4, 8, device="meta"), torch.empty(8, device="meta")).is_meta
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm(torch.empty(4, 12, device="meta"), torch.empty(12, device="meta"))
    x = torch.empty(1, 2, 40, 16, device="meta")
    bc = torch.empty(1, 40, 16, device="meta")
    assert ssd_scan(x, torch.empty(1, 2, 40, device="meta"), torch.empty(2, device="meta"), bc,
                    bc).is_meta
    bc = torch.empty(1, 40, 48, device="meta")
    with pytest.raises(ValueError, match="instantiated"):
        ssd_scan(x, torch.empty(1, 2, 40, device="meta"), torch.empty(2, device="meta"), bc, bc)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
