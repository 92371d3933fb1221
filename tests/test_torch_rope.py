"""The rotary embedding of q and k as one op (``kernels.rope``,
``layers.rope_qk``), on CPU tensors: its plain version and backward against
the eager rotary embedding the port ran before it (``_eager_rope``, two
calls, and their autograd gradients), element for element; its checks and
its path; its fake implementation, which allocates and launches nothing.
The kernel itself is held to the same plain version on a card
(``tests/test_torch_cuda.py -k rope``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rope import check_args, vector_path  # noqa: E402
from repro_torch.models.layers import rope_qk  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def _eager_rope(x, positions, theta=10_000.0):
    """The port's rotary embedding of one tensor before the kernel: a copy of
    ``repro.models.layers.rope``'s lines."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None].float() * freqs        # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rand(rng, shape, dtype, zeros=False):
    """N(0, 1) in ``dtype``; with ``zeros`` a tenth of the entries +0 or -0,
    so sums of zero products (whose sign autograd's slice sums decide) occur."""
    a = rng.standard_normal(shape).astype(np.float32)
    if zeros:
        a[rng.random(shape) < 0.1] = 0.0
        a[rng.random(shape) < 0.05] = -0.0
    return torch.from_numpy(a).to(dtype)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    wide = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}
    assert torch.equal(a.view(wide[a.dtype]), b.view(wide[b.dtype]))


# B, S, nh, nkv, hd, first position: GQA 32/4 (yi-6b) and 96/8 (nemotron,
# hd 192), prompts from 0, decode's S 1 at an offset, a per-row offset
CASES = [(1, 7, 32, 4, 128, 0), (2, 1, 32, 4, 128, 1985), (3, 5, 96, 8, 192, 40),
         (2, 9, 4, 2, 80, 3), (1, 1, 96, 8, 192, 2047), (3, 4, 6, 3, 12, 0)]


@pytest.mark.parametrize("case", CASES, ids=[f"B{c[0]}-S{c[1]}-{c[2]}x{c[3]}-hd{c[4]}-p{c[5]}"
                                             for c in CASES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_qk_equals_two_eager_calls_and_their_gradients(case, dtype):
    B, S, nh, nkv, hd, first = case
    rng = np.random.default_rng(hd + S)
    dt = DTYPES[dtype]
    positions = first + torch.arange(S).expand(B, S) + 11 * torch.arange(B)[:, None]
    q0, k0 = _rand(rng, (B, S, nh, hd), dt), _rand(rng, (B, S, nkv, hd), dt)
    gq, gk = _rand(rng, (B, S, nh, hd), dt, True), _rand(rng, (B, S, nkv, hd), dt, True)

    q, k = q0.clone().requires_grad_(), k0.clone().requires_grad_()
    want = (_eager_rope(q, positions), _eager_rope(k, positions))
    torch.autograd.backward(want, (gq, gk))

    q2, k2 = q0.clone().requires_grad_(), k0.clone().requires_grad_()
    got = rope_qk(q2, k2, positions)
    torch.autograd.backward(got, (gq, gk))
    for a, b in zip((*got, q2.grad, k2.grad), (*want, q.grad, k.grad)):
        _bits_equal(a.detach(), b.detach())


def test_backward_keeps_autograds_zero_signs():
    """Where both products of a half are -0, autograd's sum of the halves'
    zero-padded slice gradients gives +0; the plain backward too."""
    x = torch.zeros(1, 3, 1, 4, requires_grad=True)
    positions = torch.arange(3)[None]
    g = torch.full((1, 3, 1, 4), -0.0)
    _eager_rope(x, positions).backward(g)
    got = kernels.rope_bwd(g, g, *_table(positions, 2))[0]
    assert not torch.signbit(x.grad).any()
    _bits_equal(got, x.grad)


def _table(positions, half, theta=10_000.0):
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32) / half))
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def test_gradcheck_in_fp64():
    rng = np.random.default_rng(0)
    positions = torch.arange(5)[None].expand(2, 5)
    cos, sin = _table(positions, 4)
    q = _rand(rng, (2, 5, 3, 8), torch.float64).requires_grad_()
    k = _rand(rng, (2, 5, 1, 8), torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: kernels.rope(a, b, cos, sin), (q, k))


def test_plain_versions_are_the_ops_cpu_path():
    """On CPU tensors the op is ``ref.rope_ref`` / ``ref.rope_bwd_ref``, and
    nothing is counted."""
    rng = np.random.default_rng(1)
    q, k = _rand(rng, (2, 6, 4, 64), torch.bfloat16), _rand(rng, (2, 6, 2, 64), torch.bfloat16)
    cos, sin = _table(torch.arange(6)[None].expand(2, 6), 32)
    before = (kernels.rope.launches, kernels.rope_bwd.launches)
    for a, b in zip(kernels.rope(q, k, cos, sin), ref.rope_ref(q, k, cos, sin)):
        _bits_equal(a, b)
    for a, b in zip(kernels.rope_bwd(q, k, cos, sin), ref.rope_bwd_ref(q, k, cos, sin)):
        _bits_equal(a, b)
    assert (kernels.rope.launches, kernels.rope_bwd.launches) == before


@pytest.mark.parametrize("device", ["meta", "fake"])
@pytest.mark.parametrize("backward", [False, True])
def test_fake_call_allocates_the_outputs_and_launches_nothing(device, backward):
    """The dry-run's path: the CUDA path's checks and allocations (q's and
    k's layouts, as the CPU path returns them), no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rng = np.random.default_rng(2)
    cpu = (_rand(rng, (1, 35, 32, 128), torch.bfloat16),
           _rand(rng, (1, 35, 4, 128), torch.bfloat16), *_table(torch.arange(35)[None], 64))
    op = torch.ops.repro_torch_pointwise.rope
    want = op(*cpu, backward)
    before = (kernels.rope.launches, kernels.rope_bwd.launches)
    if device == "meta":
        got = op(*(t.to("meta") for t in cpu), backward)
    else:
        with FakeTensorMode() as mode:
            got = op(*(mode.from_tensor(t) for t in cpu), backward)
    assert [(t.shape, t.dtype, t.stride()) for t in got] == \
        [(t.shape, t.dtype, t.stride()) for t in want]
    assert (kernels.rope.launches, kernels.rope_bwd.launches) == before
    from repro_torch.kernels import build
    assert build.fake_impl(op.default) is not None
    assert build.fake_impl(torch.ops.aten.add.Tensor) is None


def test_kernel_path_and_counters_stay_out_of_the_kernel_counts():
    """16-byte vectors where hd/2 holds whole ones and the bases are aligned
    (hd 64, 80, 128, 192 in bf16 and fp32), single elements otherwise; the
    counters are not in ``launch_counts``."""
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    for hd in (64, 80, 128, 192):
        for dt in (torch.bfloat16, torch.float32):
            t = meta(1, 3, hd // 2, dtype=torch.float32)
            assert check_args(meta(1, 3, 4, hd, dtype=dt), meta(1, 3, 2, hd, dtype=dt), t, t)
    small = (meta(1, 3, 4, 12), meta(1, 3, 2, 12), meta(1, 3, 6, dtype=torch.float32),
             meta(1, 3, 6, dtype=torch.float32))
    assert check_args(*small) is False
    base = torch.empty(1 + 3 * 4 * 128, dtype=torch.bfloat16, device="meta")
    q = base[1:].view(1, 3, 4, 128)                     # contiguous, 2 bytes off
    t = meta(1, 3, 64, dtype=torch.float32)
    assert vector_path(q, meta(1, 3, 2, 128), t, t) is False
    assert not {"rope", "rope_bwd"} & set(kernels.launch_counts())


def test_check_args_refuses_what_the_kernel_does_not_take():
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    t = meta(1, 3, 64, dtype=torch.float32)
    q, k = meta(1, 3, 4, 128), meta(1, 3, 2, 128)
    with pytest.raises(TypeError):
        f64 = torch.float64
        check_args(meta(1, 3, 4, 128, dtype=f64), meta(1, 3, 2, 128, dtype=f64), t, t)
    with pytest.raises(TypeError):
        check_args(q, meta(1, 3, 2, 128, dtype=torch.float32), t, t)
    with pytest.raises(TypeError):
        check_args(q, k, meta(1, 3, 64), t)
    with pytest.raises(ValueError, match="contiguous"):
        check_args(meta(1, 4, 3, 128).transpose(1, 2), k, t, t)
    with pytest.raises(ValueError, match=r"\[B,S,hd/2\]"):
        check_args(q, k, meta(1, 3, 32, dtype=torch.float32), t)
    with pytest.raises(ValueError, match="even"):
        check_args(meta(1, 3, 4, 7), meta(1, 3, 2, 7), meta(1, 3, 3, dtype=torch.float32),
                   meta(1, 3, 3, dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\[B,S,nh,hd\]"):
        check_args(q, meta(1, 2, 2, 128), t, t)
