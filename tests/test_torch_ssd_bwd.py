"""The SSD scan's backward on the CPU.

The explicit chunked backward (``ref.ssd_scan_bwd_ref``) is held against
autograd of the chunked forward in fp64 (to 1e-9: only summation order
differs), and against ``jax.vjp`` of the JAX package's sequential oracle
(``repro.kernels.ref.ssd_scan_ref``) and of ``repro.models.layers.ssd_scan``
with its state options, in fp32, at the forward's tolerance
(tests/test_kernels.py:55-56, 2e-3) plus relative L2 1e-4 per output (read:
at most 4e-6). ``gradcheck`` holds the ``SSDScan`` Function in fp64.

What the wgmma backward kernel (``csrc/ssd_scan_bwd_wgmma.cu``) rests on is
held here on the plain version, in fp64: the state walks split into
segments and folded (``ref.ssd_bwd_segment_walks``) equal the serial walks,
and dB/dC summed over head groups in order (``ref.sum_head_groups``) equal
the per-head sum; so does the whole plain backward computed in the kernel's
order. Then the segment and group picker (``bwd_plan``) and the routing
between the two CUDA paths (``bwd_kernel_path``, ``check_bwd_args``). The
kernels themselves are held against the plain backward on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models.layers import ssd_scan as jax_layers_ssd_scan  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# the module, which the package's ``ssd_scan`` (the function) shadows
ssd_module = importlib.import_module("repro_torch.kernels.ssd_scan")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once, and torch's default of a thread per core in
    each of them oversubscribes the CPU (these small ops ran ~13x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


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
    """A backward kernel serves every (dtype, hp, N) the forward kernels
    take, with the state options on every path: the wgmma one where the
    forward runs its wgmma kernel (bf16 hp 64 N 16 too, hymba-1.5b's), the
    FMA one elsewhere."""
    path = ssd_module.kernel_path(dtype, hp, N)
    assert ssd_module.bwd_kernel_path(dtype, hp, N) == path
    args = _ssd_bwd_args(hp, N, dtype)
    state = torch.zeros(2, 3, hp, N)
    assert ssd_module.check_bwd_args(*args, state, state) == path


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


# ------------------------------------------------ the wgmma kernel's order

# S, chunk (so nc = 5 whole chunks, or 4 and a padded tail) and the
# segment lengths: one chunk, several with a short last segment, all in
# one, and longer than the sequence
SEG_CASES = [(320, 64), (300, 64), (65, 16)]
SEG_LENGTHS = [1, 2, 3, 5, 8]


def _walk_inputs(seed, S, chunk, long_memory, B=2, nh=3, hp=8, N=16):
    """Each chunk's own state term, its dy term and log-decay, fp64, as
    ``ref.ssd_scan_bwd_ref`` forms them, with an initial state and a
    final-state gradient."""
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a).double() for a in
                            _ssd_inputs(seed, B, nh, S, hp, N, long_memory))
    xc, dtc, Bc, Cc, acs = ref._ssd_chunks(x, dt, A, Bm, Cm, chunk)
    nc, Q = dtc.shape[2:]
    dyc = torch.nn.functional.pad(dy, (0, 0, 0, nc * Q - S)).reshape(B, nh, nc, Q, hp)
    w = torch.exp(acs[..., -1:] - acs) * dtc
    states = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], Bc)
    dy_c = torch.einsum("bhcip,bcin->bhcpn", dyc * torch.exp(acs)[..., None], Cc)
    rng = np.random.default_rng(seed + 1)
    h0, d_final = (torch.from_numpy(rng.standard_normal((B, nh, hp, N))) for _ in range(2))
    return states, dy_c, acs[..., -1], h0, d_final


@pytest.mark.parametrize("S,chunk", SEG_CASES)
@pytest.mark.parametrize("seg_chunks", SEG_LENGTHS)
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_segmented_walks_equal_the_serial_walks(S, chunk, seg_chunks, long_memory):
    """fp64: the state entering each chunk, the gradient of the state
    leaving it and the gradient of the initial state, from segments walked
    from zero and folded (the wgmma backward's kernels 2-4), equal the
    serial walks of ``ref.ssd_scan_bwd_ref``, with and without an initial
    state and a final-state gradient."""
    states, dy_c, log_decay, h0, d_final = _walk_inputs(S + seg_chunks, S, chunk, long_memory)
    decay = torch.exp(log_decay)
    for init, fin in ((None, None), (h0, d_final)):
        h_prev, _ = ref._ssd_entering(states, decay, init)
        dh, d_initial = ref._ssd_leaving(dy_c, decay, fin)
        got = ref.ssd_bwd_segment_walks(states, dy_c, log_decay, init, fin, seg_chunks)
        for name, g, w in zip(("entering", "leaving", "d_initial"), got, (h_prev, dh, d_initial)):
            assert g.dtype == torch.float64 and g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("nh,group", [(5, 1), (5, 2), (5, 3), (5, 5), (80, 4), (80, 3), (7, 16)])
def test_sum_head_groups_equals_the_per_head_sum(nh, group):
    """dB/dC summed within head groups in head order, then over the groups
    in order (the wgmma kernel's partials and their sum), equal the
    per-head sum in fp64; in fp32 the order is fixed, so the bits are those
    of the same sequence of adds."""
    t = torch.from_numpy(np.random.default_rng(nh * group).standard_normal((2, nh, 3, 4)))
    np.testing.assert_allclose(ref.sum_head_groups(t, group).numpy(), t.sum(1).numpy(),
                               rtol=1e-13, atol=1e-13)
    t32 = t.float()
    want = None
    for lo in range(0, nh, group):
        part = t32[:, lo]
        for h in range(lo + 1, min(nh, lo + group)):
            part = part + t32[:, h]
        want = part if want is None else want + part
    assert torch.equal(ref.sum_head_groups(t32, group), want)


@pytest.mark.parametrize("B,nh,S,hp,N", [(2, 5, 300, 16, 32), (1, 3, 130, 64, 128),
                                         (1, 4, 63, 32, 64)])
@pytest.mark.parametrize("seg_chunks,group", [(1, 1), (2, 2), (3, 4), (8, 3)])
def test_ssd_bwd_ref_in_the_kernels_order(B, nh, S, hp, N, seg_chunks, group):
    """fp64, chunk 64 (the kernels' chunk): the plain backward with the
    state walks segmented and dB/dC summed over head groups equals the
    default one, all six outputs, with an initial state and a final-state
    gradient."""
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a).double() for a in
                            _ssd_inputs(S + N, B, nh, S, hp, N, True))
    rng = np.random.default_rng(hp)
    h0, d_final = (torch.from_numpy(rng.standard_normal((B, nh, hp, N))) for _ in range(2))
    want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, h0, d_final, chunk=64)
    got = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, h0, d_final, chunk=64,
                               seg_chunks=seg_chunks, group=group)
    for name, g, w in zip(SSD_PARTS + ("d_initial",), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10, err_msg=name)


# mamba2-2.7b's training shape on an H100: B 1, nh 80, S 2048 (32 chunks), 132 SMs
TRAIN_SHAPE = (1, 80, 2048, 132)


# bwd_plan's choice there: the fastest plan of the sweep with more than one
# head a group (PERF.md)
BWD_PLAN_TRAIN = (4, 3)


# hymba-1.5b's (its SSM: 50 heads, N 16) and the plan its sweep fitted (PERF.md)
HYMBA_SHAPE = (1, 50, 2048, 132)
BWD_PLAN_HYMBA = (4, 2)


def _fma_scratch_bytes(B, nh, S, N, hp=64):
    """fp32 scratch of the FMA backward (``launch_bwd_fma``): the entering
    states and their gradients per chunk, the per-head dB/dC and per-chunk
    dA partials."""
    nc = -(-S // 64)
    return 4 * (2 * B * nh * nc * hp * N + 2 * B * nh * S * N + B * nh * nc)


def test_bwd_plan_at_the_training_shape():
    """The plan fitted to the training shape (PERF.md): its segments and
    head groups, and the scratch it takes, under half the FMA path's."""
    seg, group = ssd_module.bwd_plan(*TRAIN_SHAPE)
    assert (seg, group) == BWD_PLAN_TRAIN
    B, nh, S, _ = TRAIN_SHAPE
    assert ssd_module.bwd_scratch_bytes(B, nh, S, 128, seg, group) < 336e6 / 2


def test_bwd_plan_at_hymba_shape():
    """N 16 has its own costs (``BWD_COST[16]``), fitted to hymba-1.5b's
    sweep (PERF.md): the plan there, and its scratch, under the FMA path's."""
    seg, group = ssd_module.bwd_plan(*HYMBA_SHAPE, 16)
    assert (seg, group) == BWD_PLAN_HYMBA
    B, nh, S, _ = HYMBA_SHAPE
    assert ssd_module.bwd_scratch_bytes(B, nh, S, 16, seg, group) < _fma_scratch_bytes(B, nh, S, 16)


@pytest.mark.parametrize("B,nh,S,sms", [(1, 80, 2048, 132), (2, 80, 2000, 132), (2, 3, 1, 132),
                                        (1, 5, 130, 132), (2, 3, 2000, 132), (1, 24, 2048, 132),
                                        (4, 80, 4096, 132), (1, 80, 2048, 16), (1, 1, 64, 1)])
@pytest.mark.parametrize("N", [16, 64, 128])
def test_bwd_plan_choices(B, nh, S, sms, N):
    """Every plan is one the kernel takes: whole chunks a segment, at most
    the sequence; a group of at most nh heads with no empty group; the
    same answer each call."""
    nc = -(-S // 64)
    seg, group = ssd_module.bwd_plan(B, nh, S, sms, N)
    assert 1 <= seg <= nc and 1 <= group <= nh
    n_groups = -(-nh // group)
    assert n_groups * group - nh < group
    assert ssd_module.bwd_plan(B, nh, S, sms, N) == (seg, group)
    assert ssd_module.bwd_scratch_bytes(B, nh, S, N, seg, group) > 0
