"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card (the check is
made inside the ``card`` fixture). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Inputs are made with numpy from a seed; tolerances are those of
tests/test_kernels.py:16-18, and for the bf16 wgmma kernels the gate of
``_bf16_gate`` (chip_smoke.py's BF16_LIMITS).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_path as flash_path  # noqa: E402
from repro_torch.kernels.rmsnorm import bwd_kernel_path as rmsnorm_bwd_path  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel_path as rmsnorm_path  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel_path as ssd_path  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import RunCfg, init_params  # noqa: E402
from repro_torch.serving import make_prefill_step  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_GRID = [(1, 128, 4, 4, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 32), (2, 256, 6, 3, 128)]
RMS_GRID = [(64, 256), (100, 512), (256, 1024), (4, 4096)]
# B, nh, S, hp, N: tests/test_kernels.py:40-44, tiny mamba2, hymba, a short tail
SSD_GRID = [(1, 2, 256, 64, 16), (2, 3, 300, 32, 64), (1, 4, 64, 16, 128), (2, 8, 200, 32, 16),
            (1, 5, 130, 64, 128), (1, 2, 70, 64, 32)]


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=3e-4, atol=3e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, DTYPES[dtype])


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,hd", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_attention_matches_plain(card, B, S, nh, nkv, hd, dtype, window):
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, nh, S, hd), dtype, card)
    k, v = (_randn(rng, (B, nkv, S, hd), dtype, card) for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    _close(out, flash_attention_ref(q, k, v, causal=True, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,hd,window", [(2, 1000, 8, 2, 128, 0), (1, 700, 4, 1, 64, 300)])
def test_flash_attention_bf16_against_fp32(card, B, S, nh, nkv, hd, window):
    """bf16 output against fp32 attention of the same bf16 inputs, at
    limits a 3% error on some rows would break (the allclose above, at
    3e-2, would not): relative L2 overall and in the worst row within
    1e-2, and |err| within 2^-7 |ref| + 2^-6 rms(ref row)."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (B, nh, S, hd), "bfloat16", card)
    k, v = (_randn(rng, (B, nkv, S, hd), "bfloat16", card) for _ in range(2))
    out = flash_attention(q, k, v, causal=True, window=window).float()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window)
    err = out - ref
    row_rms = ref.norm(dim=-1, keepdim=True) / hd ** 0.5
    assert (err.norm() / ref.norm()).item() <= 1e-2
    assert (err.norm(dim=-1) / ref.norm(dim=-1)).max().item() <= 1e-2
    assert (err.abs() / (2 ** -7 * ref.abs() + 2 ** -6 * row_rms)).max().item() <= 1.0


def _bf16_gate(out, ref):
    """bf16 flash output against fp32 attention of the same bf16 inputs:
    relative L2 overall and in the worst row within 1e-2, and |err| within
    2^-7 |ref| + 2^-6 rms(ref row) (rows with nothing to attend to must be
    exactly 0)."""
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = out.float() - ref
    row_rms = ref.norm(dim=-1, keepdim=True) / ref.shape[-1] ** 0.5
    assert (err.norm() / ref.norm()).item() <= 1e-2
    assert (err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item() <= 1e-2
    assert (err.abs() / (2 ** -7 * ref.abs() + 2 ** -6 * row_rms).clamp_min(1e-30)).max().item() <= 1.0


# the wgmma kernel's grid: S around its 128-row tiles and yi-6b's prefill,
# its head dims, GQA groups of yi-6b (8) and hymba-1.5b (5), windows
# narrower than a tile, around it, and hymba's 1024
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 127, 128, 129, 2000])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("group", [1, 4, 5, 8])
@pytest.mark.parametrize("window", [0, 3, 96, 1024])
def test_flash_wgmma_bf16_against_fp32(card, S, hd, group, window):
    assert flash_path(torch.bfloat16, hd) == "wgmma"
    rng = np.random.default_rng(S * 1000 + hd + group * 10 + window)
    B, nkv = 2, 2
    q = _randn(rng, (B, nkv * group, S, hd), "bfloat16", card)
    k, v = (_randn(rng, (B, nkv, S, hd), "bfloat16", card) for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    _bf16_gate(out, flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                        window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("layout", ["model views", "offset base"])
def test_flash_wgmma_strided_inputs(card, hd, layout):
    """The model's [B,S,nh,hd] tensors seen as [B,nh,S,hd] (the TMA maps
    take the strides), and a q whose base sits 16 bytes into a larger
    buffer: aligned for TMA, off the 128-byte swizzle span."""
    rng = np.random.default_rng(hd)
    B, S, nh, nkv = 2, 300, 8, 2
    if layout == "model views":
        q = _randn(rng, (B, S, nh, hd), "bfloat16", card).transpose(1, 2)
        k, v = (_randn(rng, (B, S, nkv, hd), "bfloat16", card).transpose(1, 2) for _ in range(2))
    else:
        n = B * nh * S * hd
        q = _randn(rng, (n + 8,), "bfloat16", card)[8:].view(B, nh, S, hd)
        k, v = (_randn(rng, (B, nkv, S, hd), "bfloat16", card) for _ in range(2))
        assert q.data_ptr() % 16 == 0 and q.data_ptr() % 128 == 16
    out = flash_attention(q, k, v, causal=True, window=0)
    assert out.stride() == q.stride()
    _bf16_gate(out, flash_attention_ref(q.float(), k.float(), v.float(), causal=True))


# non-causal attention (hubert-xlarge: hd 80, 16 heads, no GQA), every kv
# tile live, the only mask the tail past S: S around the 128-row tiles and
# hubert's prefill length, [B,nh,S,hd] tensors and the model's views
NONCAUSAL_CASES = [(2, S, 4, 4, 80) for S in (1, 63, 130, 2000)] + [
    (2, 200, 8, 2, 64), (2, 200, 8, 2, 128), (1, 300, 4, 4, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,hd", NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("views", [False, True])
def test_flash_noncausal_forward_and_backward(card, B, S, nh, nkv, hd, dtype, views):
    """Forward (and its LSE) and backward with ``causal=False`` on the
    ``kernel_path`` / ``bwd_kernel_path`` kernels, against the plain
    versions: the forward by ``_tol`` (fp32) or ``_bf16_gate``, the
    backward by ``_bwd_gate``."""
    rng = np.random.default_rng(S + hd + nkv)
    shape = (lambda h: (B, S, h, hd)) if views else (lambda h: (B, h, S, hd))
    t = (lambda x: x.transpose(1, 2)) if views else (lambda x: x)
    q, do = (t(_randn(rng, shape(nh), dtype, card)) for _ in range(2))
    k, v = (t(_randn(rng, shape(nkv), dtype, card)) for _ in range(2))
    kernels.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal=False)
    got = kernels.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q.float(), k.float(), v.float(), causal=False)
    if dtype == "float32":
        _close(o, o_ref, dtype)
    else:
        _bf16_gate(o, o_ref)
    assert ((lse - lse_ref).abs() / (1 + lse_ref.abs())).max().item() <= LSE_LIMITS[dtype]
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                       lse_ref, causal=False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == DTYPES[dtype] and g.stride() == (q if i == 0 else k).stride()
        if S == 1 and i < 2:
            _bwd_gate(g, want[2].abs().max().item(), dtype, single_key=True)
        else:
            _bwd_gate(g, w, dtype)


@pytest.mark.cuda
def test_flash_c_entry_points_refuse_head_dims_they_do_not_take(card):
    """Each flash entry point of the library, called past the wrapper's
    checks with a head dim it has no case for (96; bf16 48 for the mma
    kernels, which take bf16 only at 32), returns an error that
    ``build.check`` raises, and launches nothing."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _strides, lse_stride
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    B, nh, S = 1, 2, 64
    for hd, dtype, code in ((96, torch.bfloat16, 1), (48, torch.bfloat16, 1),
                            (96, torch.float32, 0)):
        q, k, v, o, do, dq, dk, dv = (torch.zeros(B, nh, S, hd, device=card, dtype=dtype)
                                      for _ in range(8))
        lse, delta = (torch.zeros(B, nh, lse_stride(S), device=card) for _ in range(2))
        fwd = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
               _strides(q, k, v, o), B, nh, nh, S, hd, 0, 0, lse_stride(S))
        bwd = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr())
        strides = _strides(q, k, v, do, dq, dk, dv)
        calls = [lambda: lib.flash_attention_mma_launch(*fwd, code, stream),
                 lambda: lib.flash_attention_bwd_launch(*bwd, strides, B, nh, nh, S, hd, 0, 0,
                                                        lse_stride(S), code, stream)]
        if dtype == torch.bfloat16:
            calls += [lambda: lib.flash_attention_wgmma_launch(*fwd, stream),
                      lambda: lib.flash_attention_bwd_wgmma_launch(
                          *bwd, None, strides, B, nh, nh, S, hd, 0, 0, lse_stride(S), 1, stream),
                      lambda: lib.flash_attention_bwd_wgmma_info(hd, (ctypes.c_int * 12)())]
        for call in calls:
            with pytest.raises(RuntimeError, match="launch failed"):
                build.check(call(), f"hd {hd}")
        torch.cuda.synchronize()
        assert not o.any() and not dq.any()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [8, 2560, 4096, 5120, 8200])
@pytest.mark.parametrize("T", [1, 4, 4000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_both_versions(card, H, T, dtype):
    """The register version (bf16 at 2560, 4096, 5120) and the loop
    version (fp32, and bf16 at 8 and 8200). fp32: tests/test_kernels.py's
    3e-4; bf16 against fp32 of the same inputs: one bf16 rounding (half an
    ulp, 2^-8 relative) plus fp32 reassociation."""
    want = "rows" if dtype == "bfloat16" and H in (2560, 4096, 5120) else "loop"
    assert rmsnorm_path(DTYPES[dtype], H) == want
    rng = np.random.default_rng(T + H)
    x, w = _randn(rng, (T, H), dtype, card), _randn(rng, (H,), dtype, card)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    torch.cuda.synchronize()
    ref = rmsnorm_ref(x.float(), w.float())
    if dtype == "float32":
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=3e-4, atol=3e-4)
    else:
        err = (out.float() - ref).abs()
        assert (err / (1.01 * 2 ** -8 * ref.abs() + 1e-6)).max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_model_layout_views(card, dtype):
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 200, 4, 64), dtype, card).transpose(1, 2)   # [B,nh,S,hd] view
    k, v = (_randn(rng, (2, 200, 2, 64), dtype, card).transpose(1, 2) for _ in range(2))
    out = flash_attention(q, k, v)
    assert out.stride() == q.stride()                                # output in q's layout
    _close(out, flash_attention_ref(q, k, v), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H", RMS_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_plain(card, T, H, dtype):
    rng = np.random.default_rng(11)
    x, w = _randn(rng, (T, H), dtype, card), _randn(rng, (H,), dtype, card)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    _close(out, rmsnorm_ref(x, w), dtype)


def _ssd_close(out, ref, dtype):
    """out: the kernel's output; ref: the plain version in fp32 on the same
    inputs. fp32: tests/test_kernels.py:56's 2e-3 and relative L2 1e-4;
    bf16: relative L2 1e-2 (the bf16 wgmma path is held to the tighter
    gate of ``_bf16_gate`` below)."""
    torch.cuda.synchronize()
    if dtype == "float32":
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-3, atol=2e-3)
    rel = ((out.float() - ref).norm() / ref.norm()).item()
    assert rel <= (1e-4 if dtype == "float32" else 1e-2), rel


def _ssd_inputs(rng, B, nh, S, hp, N, dtype, device, long_memory=False):
    x = _randn(rng, (B, nh, S, hp), dtype, device)
    if long_memory:
        dt = rng.uniform(1e-3, 1e-1, (B, nh, S))
        A = -rng.uniform(1.0, 16.0, nh)
    else:
        dt = np.logaddexp(rng.standard_normal((B, nh, S)), 0)
        A = -np.exp(0.5 * rng.standard_normal(nh))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    Bm, Cm = (_randn(rng, (B, S, N), dtype, device) for _ in range(2))
    return x, f32(dt), f32(A), Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,S,hp,N", SSD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_scan_matches_plain(card, B, nh, S, hp, N, dtype, long_memory):
    """fp32: the plain version's tolerance against the Pallas kernel
    (tests/test_kernels.py:56). bf16: against fp32 of the same bf16 inputs,
    relative L2 within 1e-2 (the kernel rounds only y)."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(7), B, nh, S, hp, N, dtype, card,
                                   long_memory)
    before = ssd_scan.launches
    out = ssd_scan(x, dt, A, Bm, Cm)
    assert ssd_scan.launches == before + 1 and out.dtype == x.dtype
    _ssd_close(out, ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), chunk=64), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_takes_model_layout_views(card, dtype):
    """x a view of a column slice of the conv output, Bm/Cm slices of it,
    dt a view of a [B,S,nh] tensor; y comes back dense in x's dim order."""
    rng = np.random.default_rng(3)
    B, S, nh, hp, N = 2, 300, 4, 32, 16
    buf = _randn(rng, (B, S, nh * hp + 2 * N), dtype, card)
    x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, nh)), 0).astype(np.float32))
    dt = dt.to(card).transpose(1, 2)
    A = -torch.rand(nh, device=card) - 0.5
    out = ssd_scan(x, dt, A, Bm, Cm)
    assert out.transpose(1, 2).is_contiguous()
    _ssd_close(out, ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float()), dtype)


@pytest.mark.cuda
def test_ssd_scan_rejects_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(1)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 2, 40, 64, 16, "bfloat16", card)
    with pytest.raises(ValueError, match="hp in"):
        ssd_scan(x[..., :48], dt, A, Bm, Cm)                       # hp 48
    with pytest.raises(ValueError, match="N in"):
        ssd_scan(x, dt, A, Bm[..., :8], Cm[..., :8])               # N 8
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt.half(), A, Bm, Cm)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt, A.bfloat16(), Bm, Cm)
    with pytest.raises(TypeError, match="share a dtype"):
        ssd_scan(x, dt, A, Bm.float(), Cm)
    buf = torch.zeros(1, 40, 64 + 1, device=card, dtype=torch.bfloat16)
    x_odd = buf[..., 1:].view(1, 40, 1, 64).expand(1, 40, 2, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="aligned"):                # rows 2 bytes off
        ssd_scan(x_odd, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="unit last stride"):
        ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm)


# The bf16 wgmma path (hp 64, N 16/64/128) against fp32 of the same bf16
# inputs, at _bf16_gate's limits (chip_smoke.py's BF16_LIMITS): S around its
# 64-token chunks and the prefill length, every N, both draws of dt and A
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 500, 2000])
@pytest.mark.parametrize("N", [16, 64, 128])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_wgmma_bf16_against_fp32(card, S, N, long_memory):
    assert ssd_path(torch.bfloat16, 64, N) == "wgmma"
    rng = np.random.default_rng(S * 10 + N + long_memory)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, 3, S, 64, N, "bfloat16", card, long_memory)
    before = ssd_scan.launches
    out = ssd_scan(x, dt, A, Bm, Cm)
    assert ssd_scan.launches == before + 1 and out.dtype == torch.bfloat16
    _bf16_gate(out, ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,S,hp,N", [c for c in SSD_GRID if c[3] == 64 and c[4] != 32]
                         + [(2, 80, 2000, 64, 128), (2, 50, 2000, 64, 16)])
@pytest.mark.parametrize("long_memory", [False, True])
@pytest.mark.parametrize("views", [False, True])
def test_ssd_wgmma_grid_and_model_views(card, B, nh, S, hp, N, long_memory, views):
    """The SSD grid's wgmma cases and mamba2-2.7b's and hymba-1.5b's
    prefill shapes, dense and in the model's layout (x, Bm, Cm column
    slices of the conv output, dt a [B,nh,S] view of [B,S,nh]), at
    _bf16_gate's limits."""
    rng = np.random.default_rng(B + nh + S + N)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, nh, S, hp, N, "bfloat16", card, long_memory)
    if views:
        buf = torch.cat([x.transpose(1, 2).reshape(B, S, nh * hp), Bm, Cm], dim=-1)
        x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
        Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
        dt = dt.transpose(1, 2).contiguous().transpose(1, 2)
        assert not (x.is_contiguous() or Bm.is_contiguous() or dt.is_contiguous())
    out = ssd_scan(x, dt, A, Bm, Cm)
    assert out.stride() == torch.empty_like(x).stride()
    _bf16_gate(out, ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 65, 300, 2000])
@pytest.mark.parametrize("N", [64, 128])
def test_ssd_wgmma_initial_and_final_state(card, S, N):
    _wgmma_state_case(card, S, N)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 65, 130, 300, 2000])
def test_ssd_wgmma_n16_initial_and_final_state(card, S):
    """The state options at hymba-1.5b's N 16 on the wgmma path, as at N
    64/128: y at _bf16_gate's limits, the final state within relative L2
    1e-2, and a split sequence carried across equal to one call."""
    assert ssd_path(torch.bfloat16, 64, 16) == "wgmma"
    _wgmma_state_case(card, S, 16)


def _wgmma_state_case(card, S, N):
    """initial_state and return_state on the wgmma path: y at _bf16_gate's
    limits, the fp32 final state within relative L2 1e-2 of the plain
    version's (x o w is rounded once to bf16 in the state update), and two
    calls with the state carried across give one call's y and state."""
    rng = np.random.default_rng(S + N)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, 4, S, 64, N, "bfloat16", card, long_memory=True)
    h0 = torch.from_numpy(rng.standard_normal((2, 4, 64, N), dtype=np.float32)).to(card)
    y, h = ssd_scan(x, dt, A, Bm, Cm, initial_state=h0, return_state=True)
    y_ref, h_ref = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), initial_state=h0,
                                return_state=True)
    assert h.dtype == torch.float32 and h.shape == h0.shape
    _bf16_gate(y, y_ref)
    assert ((h - h_ref).norm() / h_ref.norm()).item() <= 1e-2
    cut = S // 2 // 64 * 64 or S // 2
    if 0 < cut < S:
        y1, h1 = ssd_scan(x[:, :, :cut], dt[:, :, :cut], A, Bm[:, :cut], Cm[:, :cut],
                          initial_state=h0, return_state=True)
        y2, h2 = ssd_scan(x[:, :, cut:], dt[:, :, cut:], A, Bm[:, cut:], Cm[:, cut:],
                          initial_state=h1, return_state=True)
        _bf16_gate(torch.cat([y1, y2], dim=2), y_ref)
        assert ((h2 - h_ref).norm() / h_ref.norm()).item() <= 1e-2


@pytest.mark.cuda
def test_ssd_kernel_path_routing(card):
    """Each (dtype, hp, N) reaches the kernel ``kernel_path`` names, and the
    state options raise on the FMA path."""
    rng = np.random.default_rng(2)
    for dtype, hp, N, path in (("bfloat16", 64, 128, "wgmma"), ("bfloat16", 64, 64, "wgmma"),
                               ("bfloat16", 64, 16, "wgmma"), ("float32", 64, 128, "fma")):
        assert ssd_path(DTYPES[dtype], hp, N) == path
        x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 2, 130, hp, N, dtype, card)
        before = ssd_scan.launches
        out = ssd_scan(x, dt, A, Bm, Cm)
        assert ssd_scan.launches == before + 1
        ref = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
        if path == "wgmma":
            _bf16_gate(out, ref)
        else:
            _ssd_close(out, ref, dtype)
            with pytest.raises(ValueError, match="wgmma path only"):
                ssd_scan(x, dt, A, Bm, Cm, return_state=True)


@pytest.mark.cuda
def test_ssd_wgmma_rejects_unaligned_views(card):
    """TMA takes only 16-byte multiples: rows of 130 bytes, and B based 2
    bytes into a buffer, raise before any launch."""
    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 2, 40, 64, 128, "bfloat16", card)
    buf = torch.zeros(1, 40, 2 * 64 + 1, device=card, dtype=torch.bfloat16)
    x_odd = buf[..., 1:].view(1, 40, 2, 64).transpose(1, 2)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan(x_odd, dt, A, Bm, Cm)
    b_off = torch.zeros(40 * 128 + 1, device=card, dtype=torch.bfloat16)[1:].view(1, 40, 128)
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan(x, dt, A, b_off, Cm)
    assert ssd_scan.launches == before


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 16, 224, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 16, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm(torch.zeros(4, 12, device=card), torch.zeros(12, device=card))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros(4, 8, device=card), torch.zeros(8, device=card, dtype=torch.bfloat16))
    x = torch.zeros(4 * 16 + 1, device=card, dtype=torch.bfloat16)[1:].view(4, 16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2      # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        rmsnorm(x, torch.ones(16, device=card, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_tiny_prefill_on_the_card_matches_the_cpu(card):
    """The same weights on the card (kernels) and on the CPU (plain
    versions) give the same fp32 prefill logits, with one flash and two
    RMSNorm launches per layer plus the final norm."""
    arch = scale_arch(get_config("yi-6b"), "tiny")
    cfg = RunCfg(compute_dtype=torch.float32)
    cpu = init_params(arch, torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = init_params(arch, torch.Generator(device=card).manual_seed(0), cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(1).integers(0, arch.vocab, (2, 100))
    kernels.reset_launch_counts()
    out = make_prefill_step(gpu)({"tokens": tokens})
    torch.cuda.synchronize()
    L = arch.num_layers
    assert kernels.launch_counts() == {"flash_attention": L, "flash_attention_bwd": 0,
                                       "rmsnorm": 2 * L + 1, "rmsnorm_bwd": 0, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0, "chain_replay": 0}
    ref = make_prefill_step(cpu)({"tokens": tokens})
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


# B, S, nh, nkv, hd: yi-6b's prefill and decode, hymba's hd 64, hubert's hd
# 80, nemotron's hd 192, and hd 12, whose halves take single elements
ROPE_GRID = [(1, 3500, 32, 4, 128), (4, 1, 32, 4, 128), (2, 300, 25, 5, 64), (2, 130, 16, 16, 80),
             (1, 70, 96, 8, 192), (2, 33, 6, 3, 12)]


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,hd", ROPE_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_kernel_equals_plain_bit_for_bit(card, B, S, nh, nkv, hd, dtype):
    """Forward and backward, one launch each, bit-equal to ``ref.rope_ref``
    and to autograd's gradient of it; gradients with +0 and -0 entries."""
    from repro_torch.kernels.rope import vector_path
    rng = np.random.default_rng(hd + S)
    q, k = _randn(rng, (B, S, nh, hd), dtype, card), _randn(rng, (B, S, nkv, hd), dtype, card)
    gq, gk = _randn(rng, (B, S, nh, hd), dtype, card), _randn(rng, (B, S, nkv, hd), dtype, card)
    gq[..., ::7], gk[..., 1::5] = 0.0, -0.0
    positions = 1985 * (S == 1) + torch.arange(S, device=card).expand(B, S)
    freqs = 1.0 / (10_000.0 ** (torch.arange(hd // 2, dtype=torch.float32, device=card)
                                / (hd // 2)))
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    assert vector_path(q, k, cos, sin) == (hd != 12)
    before = (kernels.rope.launches, kernels.rope_bwd.launches)
    qk = kernels.rope(q, k, cos, sin)
    dqk = kernels.rope_bwd(gq, gk, cos, sin)
    torch.cuda.synchronize()
    assert (kernels.rope.launches, kernels.rope_bwd.launches) == (before[0] + 1, before[1] + 1)
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    want = ref.rope_ref(qa, ka, cos, sin)
    torch.autograd.backward(want, (gq, gk))
    for got, ref_t in zip((*qk, *dqk), (*want, qa.grad, ka.grad)):
        assert torch.equal(_bits(got), _bits(ref_t.detach()))


@pytest.mark.cuda
def test_yi6b_forward_launches_rope_once_a_layer(card):
    """Full-width yi-6b, one bf16 prefill: one rope launch a layer and none
    of the backward, beside the parent's counts (65 RMSNorm, 32 flash)."""
    arch = scale_arch(get_config("yi-6b"), "full")
    model = init_params(arch, torch.Generator(device=card).manual_seed(0),
                        RunCfg(compute_dtype=torch.bfloat16), device=card)
    tokens = torch.randint(0, arch.vocab, (1, 300), device=card)
    kernels.reset_launch_counts()
    make_prefill_step(model)({"tokens": tokens})
    torch.cuda.synchronize()
    assert (kernels.rope.launches, kernels.rope_bwd.launches) == (arch.num_layers, 0) == (32, 0)
    assert kernels.launch_counts() == {"flash_attention": 32, "flash_attention_bwd": 0,
                                       "rmsnorm": 65, "rmsnorm_bwd": 0, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0, "chain_replay": 0}


@pytest.mark.cuda
def test_tiny_mamba2_prefill_on_the_card_matches_the_cpu(card):
    """The same for tiny mamba2, over 300 tokens (past a 256-token chunk):
    one SSD and two RMSNorm launches per layer plus the final norm."""
    arch = scale_arch(get_config("mamba2-2.7b"), "tiny")
    cfg = RunCfg(compute_dtype=torch.float32)
    cpu = init_params(arch, torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = init_params(arch, torch.Generator(device=card).manual_seed(0), cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(1).integers(0, arch.vocab, (2, 300))
    kernels.reset_launch_counts()
    out = make_prefill_step(gpu)({"tokens": tokens})
    torch.cuda.synchronize()
    L = arch.num_layers
    assert kernels.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                       "rmsnorm": 2 * L + 1, "rmsnorm_bwd": 0, "ssd_scan": L,
                                       "ssd_scan_bwd": 0, "chain_replay": 0}
    ref = make_prefill_step(cpu)({"tokens": tokens})
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hymba-1.5b", "granite-moe-3b-a800m"])
def test_tiny_hybrid_and_moe_prefill_on_the_card_matches_the_cpu(card, name):
    """The same for tiny hymba (over 100 tokens, past its window of 64: a
    flash and an SSD launch and three RMSNorms per layer) and tiny
    granite-moe (a flash and two RMSNorms per layer; the MoE layer is plain
    PyTorch on both devices)."""
    arch = scale_arch(get_config(name), "tiny")
    cfg = RunCfg(compute_dtype=torch.float32)
    cpu = init_params(arch, torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = init_params(arch, torch.Generator(device=card).manual_seed(0), cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(1).integers(0, arch.vocab, (2, 100))
    kernels.reset_launch_counts()
    out = make_prefill_step(gpu)({"tokens": tokens})
    torch.cuda.synchronize()
    L, hybrid = arch.num_layers, arch.block == "hymba"
    assert kernels.launch_counts() == {"flash_attention": L, "flash_attention_bwd": 0,
                                       "rmsnorm": (3 if hybrid else 2) * L + 1,
                                       "rmsnorm_bwd": 0, "ssd_scan": L if hybrid else 0,
                                       "ssd_scan_bwd": 0, "chain_replay": 0}
    ref = make_prefill_step(cpu)({"tokens": tokens})
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hubert-xlarge", "llava-next-34b"])
def test_tiny_embeds_prefill_on_the_card_matches_the_cpu(card, name):
    """The same for the embeds-input archs over 100 positions of random
    embeddings: hubert (non-causal, logits at every position) and llava
    (causal, the last position's); a flash and two RMSNorms per layer."""
    arch = scale_arch(get_config(name), "tiny")
    cfg = RunCfg(compute_dtype=torch.float32)
    cpu = init_params(arch, torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = init_params(arch, torch.Generator(device=card).manual_seed(0), cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    embeds = np.random.default_rng(1).standard_normal((2, 100, arch.d_model)).astype(np.float32)
    kernels.reset_launch_counts()
    out = make_prefill_step(gpu)({"embeds": embeds})
    torch.cuda.synchronize()
    L = arch.num_layers
    assert kernels.launch_counts() == {"flash_attention": L, "flash_attention_bwd": 0,
                                       "rmsnorm": 2 * L + 1, "rmsnorm_bwd": 0, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0, "chain_replay": 0}
    ref = make_prefill_step(cpu)({"embeds": embeds})
    assert out.shape == ref.shape == (2, 100 if not arch.causal else 1, arch.vocab)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- backward kernels

def _bwd_gate(out, ref, dtype, single_key=False):
    """A backward kernel's output against the plain backward in fp32 on the
    same inputs. fp32: relative L2 within 1e-4. bf16: relative L2 overall
    and in the worst row within 1e-2, |err| within 2^-7 |ref| + 2^-6
    rms(ref row) + 2^-6 rms(ref); a row's error is taken against its norm
    plus 2^-6 of the typical row norm (a row whose exact gradient cancels
    to ~0, such as the first causal row of dq, is rounding noise on both
    sides). ``single_key``: S = 1, where dq and dk are exactly 0 (one live
    key: dS = P (dO.v - dO.o) with o = v), and both sides are rounding
    noise; they must stay below 1e-3 of max |dv|, passed as ``ref``'s
    scale instead."""
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    out = out.float()
    if single_key:
        assert out.abs().max().item() <= 1e-3 * ref
        return
    err = out - ref
    rel = (err.norm() / ref.norm()).item()
    if dtype == "float32":
        assert rel <= 1e-4
        return
    R, E = ref.reshape(-1, ref.shape[-1]), err.reshape(-1, ref.shape[-1])
    rows = R.norm(dim=-1)
    typical = R.norm() / R.shape[0] ** 0.5
    assert rel <= 1e-2
    assert (E.norm(dim=-1) / (rows + 2 ** -6 * typical)).max().item() <= 1e-2
    rms = typical / R.shape[-1] ** 0.5
    limit = 2 ** -7 * R.abs() + 2 ** -6 * rows[:, None] / R.shape[-1] ** 0.5 + 2 ** -6 * rms
    assert (E.abs() / limit).max().item() <= 1.0


# chip_smoke.py's backward cases: hd 32/64/80/128, GQA groups 1, 2, 8, S 1,
# 127, 200 and 2048, causal, one window; B, S, nh, nkv, window
FLASH_BWD_CASES = [(1, 1, 2, 2, 0), (2, 127, 4, 2, 0), (1, 200, 8, 1, 0), (1, 200, 4, 4, 37),
                   (1, 2048, 8, 1, 0), (1, 2048, 32, 4, 0)]
# hymba-1.5b's attention: nh 25, nkv 5 (group 5), hd 64, window 1024
FLASH_BWD_HYMBA = (1, 2048, 25, 5, 1024)
# the forward kernels' LSE against the plain forward's: max |err| / (1 + |ref|)
# (chip_smoke.py LSE_LIMITS)
LSE_LIMITS = {"float32": 1e-5, "bfloat16": 2 ** -10}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain(card, B, S, nh, nkv, window, hd, dtype):
    """The backward path of ``bwd_kernel_path`` (wgmma for bf16 hd 64/128),
    fed the forward kernel's LSE, against the plain backward fed the plain
    forward's."""
    rng = np.random.default_rng(S + hd + nh)
    q = _randn(rng, (B, nh, S, hd), dtype, card)
    k, v = (_randn(rng, (B, nkv, S, hd), dtype, card) for _ in range(2))
    do = _randn(rng, (B, nh, S, hd), dtype, card)
    o, lse = flash_attention_fwd(q, k, v, causal=True, window=window)
    before = kernels.flash_attention_bwd.launches
    got = kernels.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window)
    assert kernels.flash_attention_bwd.launches == before + 1
    _, lse_ref = ref.flash_attention_fwd_ref(q.float(), k.float(), v.float(), causal=True,
                                             window=window)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                       lse_ref, causal=True, window=window)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == DTYPES[dtype] and g.shape == w.shape
        if S == 1 and i < 2:
            _bwd_gate(g, want[2].abs().max().item(), dtype, single_key=True)
        else:
            _bwd_gate(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_wgmma_bwd_hymba_shape(card, hd):
    """The wgmma backward at hymba-1.5b's attention shape (GQA group 5, one
    slice or five, window 1024, S 2048), at hd 64 and 128."""
    B, S, nh, nkv, window = FLASH_BWD_HYMBA
    rng = np.random.default_rng(hd)
    q = _randn(rng, (B, nh, S, hd), "bfloat16", card)
    k, v = (_randn(rng, (B, nkv, S, hd), "bfloat16", card) for _ in range(2))
    do = _randn(rng, (B, nh, S, hd), "bfloat16", card)
    o, lse = flash_attention_fwd(q, k, v, window=window)
    _, lse_ref = ref.flash_attention_fwd_ref(q.float(), k.float(), v.float(), window=window)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                       lse_ref, window=window)
    for slices in (1, 5):
        got = kernels.flash_attention_bwd(q, k, v, o, do, lse, window=window, slices=slices)
        for g, w in zip(got, want):
            _bwd_gate(g, w, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,window", FLASH_BWD_CASES + [FLASH_BWD_HYMBA])
@pytest.mark.parametrize("hd,dtype", [(32, "float32"), (80, "float32"), (128, "float32"),
                                      (32, "bfloat16"), (64, "bfloat16"), (80, "bfloat16"),
                                      (128, "bfloat16")])
def test_flash_forward_lse_matches_plain(card, B, S, nh, nkv, window, hd, dtype):
    """The LSE that each forward kernel writes for the backward (log2 units)
    against the plain forward's; o is the same with and without it."""
    rng = np.random.default_rng(S + hd + 7)
    q = _randn(rng, (B, nh, S, hd), dtype, card)
    k, v = (_randn(rng, (B, nkv, S, hd), dtype, card) for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, window=window)
    o_plain, none = flash_attention_fwd(q, k, v, window=window, lse=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o, o_plain)
    _, want = ref.flash_attention_fwd_ref(q.float(), k.float(), v.float(), window=window)
    assert lse.shape == (B, nh, S) and torch.isfinite(lse).all()
    assert ((lse - want).abs() / (1 + want.abs())).max().item() <= LSE_LIMITS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,slices", [(32, "float32", 0), (32, "bfloat16", 0)] + [
    (hd, "bfloat16", slices) for hd in (64, 128, 192) for slices in (0, 1, 2, 8)])
def test_flash_bwd_gives_the_same_bits_twice(card, hd, dtype, slices):
    """No atomics: two backward calls on the same inputs give identical
    bits, on both paths and for any number of GQA slices (0: the
    wrapper's choice)."""
    B, S, nh, nkv = 1, 1000, 16, 2
    rng = np.random.default_rng(hd + slices)
    q = _randn(rng, (B, nh, S, hd), dtype, card)
    k, v = (_randn(rng, (B, nkv, S, hd), dtype, card) for _ in range(2))
    do = _randn(rng, (B, nh, S, hd), dtype, card)
    o, lse = flash_attention_fwd(q, k, v)
    first = kernels.flash_attention_bwd(q, k, v, o, do, lse, slices=slices)
    second = kernels.flash_attention_bwd(q, k, v, o, do, lse, slices=slices)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_autograd_on_the_card_launches_the_backward(card, dtype):
    """With grad on, the output of ``kernels.flash_attention`` on the model's
    [B,S,nh,hd] views carries a grad_fn whose backward launches the
    backward kernel, in the inputs' layouts."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 300, 8, 64), dtype, card).requires_grad_()
    k, v = (_randn(rng, (2, 300, 2, 64), dtype, card).requires_grad_() for _ in range(2))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=100)
    assert o.grad_fn is not None
    do = _randn(rng, (2, 300, 8, 64), dtype, card).transpose(1, 2)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(o, (q, k, v), do)
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(*(t.detach().float().transpose(1, 2) for t in (q, k, v)),
                                       o.detach().float(), do.float(), window=100)
    for g, w in zip(got, want):
        _bwd_gate(g, w.transpose(1, 2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H", [(1, 2560), (5, 2560), (2048, 2560), (3, 4096), (2048, 4096),
                                 (1, 5120), (600, 5120), (2048, 5120), (1, 1600), (7, 1600),
                                 (2048, 1600), (300, 3200), (2048, 3200), (9, 1536),
                                 (2048, 1536)])
def test_rmsnorm_bwd_register_version(card, T, H):
    """The register backward (bf16 at the BWD_ROW_GROUPS widths: 1536,
    1600 and 3200 with a predicated last vector, 8 row groups a CTA at the
    first two), against the plain backward, the same bits twice, and routed
    as ``bwd_kernel_path`` says; fp32 at the same widths takes the loop
    version."""
    assert rmsnorm_bwd_path(torch.bfloat16, H) == "rows"
    assert rmsnorm_bwd_path(torch.float32, H) == "loop"
    rng = np.random.default_rng(T * 7 + H)
    x, dy = _randn(rng, (T, H), "bfloat16", card), _randn(rng, (T, H), "bfloat16", card)
    w = _randn(rng, (H,), "bfloat16", card)
    dx, dw = kernels.rmsnorm_bwd(x, w, dy)
    dx2, dw2 = kernels.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    want = ref.rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
    _bwd_gate(dx, want[0], "bfloat16")
    _bwd_gate(dw[None], want[1][None], "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("T,H", [(1, 256), (7, 4096), (300, 1000), (2048, 4096), (4096, 4096),
                                 (33, 12288)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_matches_plain(card, T, H, dtype):
    rng = np.random.default_rng(T + H)
    x, dy = _randn(rng, (T, H), dtype, card), _randn(rng, (T, H), dtype, card)
    w = _randn(rng, (H,), dtype, card).requires_grad_()
    xg = x.clone().requires_grad_()
    y = rmsnorm(xg, w)
    assert y.grad_fn is not None
    kernels.reset_launch_counts()
    dx, dw = torch.autograd.grad(y, (xg, w), dy)
    assert kernels.launch_counts()["rmsnorm_bwd"] == 1
    want = ref.rmsnorm_bwd_ref(x.float(), w.detach().float(), dy.float())
    _bwd_gate(dx, want[0], dtype)
    _bwd_gate(dw[None], want[1][None], dtype)


def _ssd_bwd_close(got, want, dtype):
    """The SSD backward kernel's (dx, ddt, dA, dBm, dCm, d_initial) against
    the plain backward in fp32 on the same inputs: ``_bwd_gate`` per output,
    fp32 outputs (ddt, dA, d_initial, and all of an fp32 call) at relative
    L2 1e-4; dA, a sum over b and s, as one vector; an exactly-zero dA (S =
    1 from a zero state) must come out exactly zero."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            g, w = g[None], w[None]
        if not w.abs().max().item():
            torch.cuda.synchronize()
            assert not g.abs().max().item()
            continue
        _bwd_gate(g, w, dtype if g.dtype == torch.bfloat16 else "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,S,hp,N", SSD_GRID + [(2, 3, 1, 64, 128), (1, 2, 2048, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_scan_bwd_matches_plain(card, B, nh, S, hp, N, dtype, long_memory):
    """``csrc/ssd_scan_bwd.cu`` against the plain backward, one launch
    counted, and a second call equal bit for bit."""
    from repro_torch.kernels import ssd_scan_bwd
    rng = np.random.default_rng(S + hp + N)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, nh, S, hp, N, dtype, card, long_memory)
    dy = _randn(rng, x.shape, dtype, card)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, dy)
    assert ssd_scan_bwd.launches == before + 1
    again = ssd_scan_bwd(x, dt, A, Bm, Cm, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [t.dtype for t in got] == [x.dtype, torch.float32, torch.float32, x.dtype, x.dtype,
                                      torch.float32]
    want = ref.ssd_scan_bwd_ref(x.float(), dt, A, Bm.float(), Cm.float(), dy.float())
    _ssd_bwd_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hp,N", [(64, 128), (32, 16), (64, 16)])
def test_ssd_scan_bwd_model_layout_and_state(card, dtype, hp, N):
    """x, Bm, Cm column slices of one buffer, dt and dy [B,nh,S] / [B,nh,S,hp]
    views of [B,S,.] tensors, an initial state and a final-state gradient:
    dx and ddt come back in x's and dt's layouts."""
    from repro_torch.kernels import ssd_scan_bwd
    rng = np.random.default_rng(hp + N)
    B, S, nh = 2, 300, 4
    buf = _randn(rng, (B, S, nh * hp + 2 * N), dtype, card)
    x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
    Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (B, S, nh)).astype(np.float32)).to(card)
    dt = dt.transpose(1, 2)
    A = -torch.from_numpy(rng.uniform(1.0, 16.0, nh).astype(np.float32)).to(card)
    dy = _randn(rng, (B, S, nh, hp), dtype, card).transpose(1, 2)
    h0, d_final = (torch.from_numpy(rng.standard_normal((B, nh, hp, N), dtype=np.float32))
                   .to(card) for _ in range(2))
    got = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, h0, d_final)
    assert got[0].transpose(1, 2).is_contiguous() and got[1].transpose(1, 2).is_contiguous()
    want = ref.ssd_scan_bwd_ref(x.float(), dt, A, Bm.float(), Cm.float(), dy.float(), h0,
                                d_final)
    _ssd_bwd_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,S,N", [(2, 3, 1, 128), (1, 5, 130, 64), (2, 7, 700, 128),
                                      (1, 80, 2048, 128), (2, 3, 1, 16), (1, 5, 130, 16),
                                      (2, 7, 700, 16), (1, 50, 2048, 16)])
@pytest.mark.parametrize("long_memory", [False, True])
def test_ssd_bwd_wgmma_path_and_plans(card, B, nh, S, N, long_memory):
    """bf16 at hp 64 routes to ``csrc/ssd_scan_bwd_wgmma.cu``, at N 16 too
    (hymba-1.5b: B and C tiles by plain loads, transposed). Its outputs
    pass the gate against the plain backward at ``bwd_plan``'s plan and at
    other (segment length, head group) plans, each of which repeats its own
    bits; and the FMA kernel on the same inputs passes it too."""
    from repro_torch.kernels.ssd_scan import (_bwd_outputs, _launch_bwd_wgmma, bwd_kernel_path,
                                              launch_bwd_fma)
    assert bwd_kernel_path(torch.bfloat16, 64, N) == "wgmma"
    rng = np.random.default_rng(S + N)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, nh, S, 64, N, "bfloat16", card, long_memory)
    dy = _randn(rng, x.shape, "bfloat16", card)
    h0, d_final = (torch.from_numpy(rng.standard_normal((B, nh, 64, N), dtype=np.float32))
                   .to(card) for _ in range(2))
    want = ref.ssd_scan_bwd_ref(x.float(), dt, A, Bm.float(), Cm.float(), dy.float(), h0,
                                d_final)
    nc = -(-S // 64)
    for plan in (None, (1, 1), (2, 3), (nc, nh), (max(1, nc // 3), 2)):
        got = _bwd_outputs(x, dt, Bm)
        _launch_bwd_wgmma(x, dt, A, Bm, Cm, dy, h0, d_final, got, plan)
        again = _bwd_outputs(x, dt, Bm)
        _launch_bwd_wgmma(x, dt, A, Bm, Cm, dy, h0, d_final, again, plan)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), plan
        _ssd_bwd_close(got, want, "bfloat16")
    _ssd_bwd_close(launch_bwd_fma(x, dt, A, Bm, Cm, dy, h0, d_final), want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_autograd_on_the_card_launches_the_backward(card, dtype):
    """``kernels.ssd_scan`` on CUDA tensors that require grad carries a
    gradient: one forward and one backward launch, the backward equal to
    the wrapper's on the same dy."""
    from repro_torch.kernels import ssd_scan_bwd
    rng = np.random.default_rng(2)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 2, 130, 64, 128, dtype, card)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    dy = _randn(rng, x.shape, dtype, card)
    kernels.reset_launch_counts()
    y = ssd_scan(*leaves)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, leaves, dy)
    counts = kernels.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    want = ssd_scan_bwd(x, dt, A, Bm, Cm, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(grads, want[:5]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yi-6b", "mamba2-2.7b", "hymba-1.5b", "granite-moe-3b-a800m",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("scale,layers", [("tiny", None), ("full", 2)])
def test_train_step_kernels_match_plain(card, name, scale, layers):
    """The gradients of one fp32 train step (G = 2) on the card through the
    kernels against the plain versions, from the same masters and batch:
    loss within 1e-5 and each gradient within 1e-3 relative L2. Each
    trained arch tiny, and at full width cut to 2 layers; wq, wk, wv, wi,
    wg (the experts' too) and in_proj at fan-in H, as chip_smoke.py
    gates: under the
    reference's init attention is a hard argmax and two correct backwards
    differ by percents even in fp32 (PERF.md, ROADMAP §3)."""
    import dataclasses
    from repro_torch.train.data import DataCfg, SyntheticDataset
    from repro_torch.train.optim import OptimizerCfg
    from repro_torch.train.step import TrainCfg, accumulate_grads, init_train_state, sync_model

    arch = scale_arch(get_config(name), scale)
    if layers:
        arch = dataclasses.replace(arch, num_layers=layers)
    cfg = TrainCfg(run=RunCfg(compute_dtype=torch.float32, remat=False), opt=OptimizerCfg(),
                   num_microbatches=2)
    S = 256 if scale == "tiny" else 1024
    batch = SyntheticDataset(arch, DataCfg(seq_len=S, global_batch=2, num_microbatches=2)) \
        .batch_at(0)
    state = init_train_state(arch, cfg, torch.Generator(device=card).manual_seed(0), card)
    with torch.no_grad():
        for leaf, master in state.params.items():
            if leaf.split(".")[-1] in ("wq", "wk", "wv", "wi", "wg", "in_proj"):
                master.mul_((arch.num_layers / arch.d_model) ** 0.5)
    sync_model(state)
    kernels.reset_launch_counts()
    gk, lk, _ = accumulate_grads(state.model, batch, cfg)
    counts = kernels.launch_counts()
    L = arch.num_layers
    attn = 2 * L if arch.has_attention else 0
    ssm = 2 * L if arch.block in ("ssm", "hymba") else 0
    norms = 2 * ((3 if arch.block == "hymba" else 2) * L + 1)
    assert counts == {"flash_attention": attn, "flash_attention_bwd": attn, "rmsnorm": norms,
                      "rmsnorm_bwd": norms, "ssd_scan": ssm, "ssd_scan_bwd": ssm,
                      "chain_replay": 0}
    assert (kernels.rope.launches, kernels.rope_bwd.launches) == (attn, attn)
    with _plain_versions():
        gp, lp, _ = accumulate_grads(state.model, batch, cfg)
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for n in gk:
        rel = ((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3, (n, rel)


@contextlib.contextmanager
def _plain_versions():
    """The model's flash, RMSNorm, rope and SSD calls through their plain
    versions."""
    saved = {n: getattr(kernels, n) for n in ("flash_attention", "rmsnorm", "rope", "ssd_scan")}
    try:
        kernels.flash_attention = ref.flash_attention_ref
        kernels.rmsnorm = ref.rmsnorm_ref
        kernels.rope = ref.rope_ref
        kernels.ssd_scan = ref.ssd_scan_ref
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale,layers", [
    pytest.param(n, s, l, id=f"{s}-{l}-{n}") for s, l, names in (
        ("tiny", None, ("yi-6b", "mamba2-2.7b", "hymba-1.5b", "granite-moe-3b-a800m",
                        "hubert-xlarge")),
        ("full", 2, ("yi-6b", "mamba2-2.7b"))) for n in names])
def test_train_grads_as_close_to_fp64_as_plain(card, name, scale, layers):
    """Under the reference's own init, where fp32 rounding alone moves the
    gradients by percents at full width (hard-argmax attention; PERF.md):
    the fp32 gradients of G = 2 microbatches through the kernels sit as
    close to fp64 of the same weights (plain versions) as the fp32 plain
    versions do: each leaf and the whole gradient within 1.5x the plain
    versions' relative L2 distance, or 1e-4. Each trained arch tiny, and
    yi-6b and mamba2 at full width cut to 2 layers, as chip_smoke.py
    gates. At full width (2 layers, S 1024, this batch) hymba read 1.508x
    on layer 0's dt_bias and granite-moe 25x on final_norm: there fp32
    rounding flips a token's experts against fp64, so the two routes see
    different routings; chip_smoke.py gates both at S 2048 and reports
    the readings."""
    import dataclasses
    from repro_torch.models.lm import LM
    from repro_torch.train.data import DataCfg, SyntheticDataset
    from repro_torch.train.step import TrainCfg, accumulate_grads

    arch = scale_arch(get_config(name), scale)
    if layers:
        arch = dataclasses.replace(arch, num_layers=layers)
    S = 256 if scale == "tiny" else 1024
    batch = SyntheticDataset(arch, DataCfg(seq_len=S, global_batch=2, num_microbatches=2)) \
        .batch_at(0)
    cfg = TrainCfg(run=RunCfg(compute_dtype=torch.float32), num_microbatches=2)
    model = init_params(arch, torch.Generator(device=card).manual_seed(0),
                        RunCfg(compute_dtype=torch.float32, remat=False), device=card)
    gk, _, _ = accumulate_grads(model, batch, cfg)
    with _plain_versions():
        gp, _, _ = accumulate_grads(model, batch, cfg)
    model64 = LM(arch, RunCfg(compute_dtype=torch.float64, remat=False), device=card)
    model64.load_state_dict(model.state_dict())
    del model
    with _plain_versions():
        g64, _, _ = accumulate_grads(model64, batch, dataclasses.replace(
            cfg, run=RunCfg(compute_dtype=torch.float64), grad_accum_dtype=torch.float64))
    err = {"kernels": 0.0, "plain": 0.0}
    for n, want in g64.items():
        dk, dp = (gk[n] - want).norm().item(), (gp[n] - want).norm().item()
        err["kernels"] += dk ** 2
        err["plain"] += dp ** 2
        scale_n = want.norm().item()
        assert dk <= max(1.5 * dp, 1e-4 * scale_n), (n, dk / scale_n, dp / scale_n)
    total = sum(w.norm().item() ** 2 for w in g64.values()) ** 0.5
    assert err["kernels"] ** 0.5 <= max(1.5 * err["plain"] ** 0.5, 1e-4 * total), err


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 31, 256, 4096])
def test_chain_replay_equals_plain_version(card, G):
    """``chain_replay`` against ``chain_replay_ref`` on the same CUDA tensors:
    a program of every node kind nesting par/spawn to the kernel's depth
    limit, bit for bit (fp64 adds only, in the same order)."""
    from repro_torch.core.fastbatch import compile_chain
    from repro_torch.kernels.chain_replay import MAX_DEPTH, chain_replay

    def chain(depth):
        inner = [("dt", 1.0), ("hold", (5, 1 << 33), 1.0), ("bytes", "noc", 1.0),
                 ("bytes", "fabric", 1.0), ("spawn", (("dt", 1.0), ("bytes", "dram", 1.0)))]
        if depth > 1:
            inner.append(("par", (tuple(chain(depth - 1)), (("dt", 1.0),), ())))
        return inner
    code, prog, leaves = compile_chain(chain(MAX_DEPTH))
    assert prog.depth == MAX_DEPTH
    rng = np.random.default_rng(G)
    scale = rng.choice([1.0, 1e-3, 1e8, 3e15], size=(len(leaves), G))
    V = torch.tensor(scale * rng.random((len(leaves), G)), device=card)
    t = torch.tensor(rng.random(G), device=card)
    accs = torch.tensor(rng.random((3, G)), device=card)
    code = torch.from_numpy(code).to(card)
    kernels.reset_launch_counts()
    got_accs = accs.clone()
    got = chain_replay(code, V, t, got_accs, entry=prog.entry, holds=len(prog.keys),
                       spawns=prog.spawns, depth=prog.depth)
    assert kernels.launch_counts()["chain_replay"] == 1
    want_accs = accs.clone()
    want = ref.chain_replay_ref(code, V, t, want_accs, prog.entry, len(prog.keys), prog.spawns,
                                prog.depth)
    torch.cuda.synchronize()
    for a, b in zip((*got, got_accs), (*want, want_accs)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_run_fast_batch_card_equals_cpu(card):
    """The batched tier on the card and on the CPU: every job's result and
    raw trace equal, timelines on and off (both validation paths)."""
    from repro_torch import core
    for timeline in (True, False):
        def sims():
            out = []
            for flops in (2e12, 4e12, 8e12, 16e12):
                spec = core.MeshSpec(rows=4, cols=4, intra_bw=64e9, inter_bw=16e9,
                                     link_latency=2e-8, tile_shape=(2, 2))
                hw = core.HardwareSpec(name=f"m{flops:g}", topology=spec,
                                       tile=core.TileSpec(flops=flops, sram_bytes=2e6),
                                       dram=core.DRAMSpec(bandwidth=64e9, response_time=3e-7,
                                                          channels=4))
                for pp, training in ((2, True), (4, False)):
                    plan = core.ParallelPlan(pp=pp, microbatch=1, global_batch=4,
                                             recompute="never", training=training)
                    graph = core.transformer_lm_graph("t", 2, 256, 4, 64, 1, vocab=512)
                    out.append(core.PipelineSimulator(core.map_graph(graph, hw, plan),
                                                      collect_timeline=timeline))
            return out
        prof = {}
        a = core.run_fast_batch(sims(), device=card, profile=prof)
        b = core.run_fast_batch(sims(), device="cpu")
        assert prof["batched_jobs"] == len(a)
        for (ra, why_a), (rb, why_b) in zip(a, b):
            assert why_a == why_b
            if ra is not None:
                assert (ra.total_time, ra.throughput, ra.noc_bytes, ra.dram_bytes,
                        ra.trace.to_bytes()) == (rb.total_time, rb.throughput, rb.noc_bytes,
                                                 rb.dram_bytes, rb.trace.to_bytes())


@pytest.mark.cuda
def test_experiment_sweep_on_the_card_equals_the_cpu(card):
    """A small co-design sweep through ``Experiment.sweep``: the batched
    tier on the card (``chain_replay`` launched) gives the CPU's report."""
    from repro_torch import api, core
    exp = api.Experiment(arch="yi-6b", hardware=core.tpu_v5e_pod(2, 2), seq_len=128,
                         global_batch=8, engine="auto",
                         search=api.SearchSpace(max_plans=4, microbatch_sizes=(1, 2)),
                         hardware_search=api.HardwareSearchSpace(
                             tile_flops=(100e12, 197e12), dram_bandwidth=(400e9, 819e9)))
    kernels.reset_launch_counts()
    on_card = exp.sweep(device=card, profile=True)
    assert kernels.launch_counts()["chain_replay"] > 0
    on_cpu = exp.sweep(device="cpu")
    assert on_card.profile["batched_jobs"] == on_card.num_candidates
    on_card.profile = None
    assert on_card.to_json() == on_cpu.to_json()
