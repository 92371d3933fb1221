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
from repro_torch.kernels.flash_attention import kernel_path as flash_path  # noqa: E402
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
# both head dims, GQA groups of yi-6b (8) and hymba-1.5b (5), windows
# narrower than a tile, around it, and hymba's 1024
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 127, 128, 129, 2000])
@pytest.mark.parametrize("hd", [64, 128])
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
@pytest.mark.parametrize("hd", [64, 128])
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


# The bf16 wgmma path (hp 64, N 64/128) against fp32 of the same bf16
# inputs, at _bf16_gate's limits (chip_smoke.py's BF16_LIMITS): S around its
# 64-token chunks and mamba2-2.7b's prefill, both N, both draws of dt and A
@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 500, 2000])
@pytest.mark.parametrize("N", [64, 128])
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
@pytest.mark.parametrize("B,nh,S,hp,N", [c for c in SSD_GRID if c[3] == 64 and c[4] in (64, 128)]
                         + [(2, 80, 2000, 64, 128)])
@pytest.mark.parametrize("long_memory", [False, True])
@pytest.mark.parametrize("views", [False, True])
def test_ssd_wgmma_grid_and_model_views(card, B, nh, S, hp, N, long_memory, views):
    """The SSD grid's wgmma cases and mamba2-2.7b's prefill shape, dense
    and in the model's layout (x, Bm, Cm column slices of the conv output,
    dt a [B,nh,S] view of [B,S,nh]), at _bf16_gate's limits."""
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
                               ("bfloat16", 64, 16, "fma"), ("float32", 64, 128, "fma")):
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
    q = torch.zeros(1, 2, 16, 80, device=card, dtype=torch.bfloat16)
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
                                       "rmsnorm": 2 * L + 1, "rmsnorm_bwd": 0, "ssd_scan": 0}
    ref = make_prefill_step(cpu)({"tokens": tokens})
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


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
                                       "rmsnorm": 2 * L + 1, "rmsnorm_bwd": 0, "ssd_scan": L}
    ref = make_prefill_step(cpu)({"tokens": tokens})
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


# chip_smoke.py's backward cases: hd 32/64/128, GQA groups 1, 2, 8, S 1,
# 127, 200 and 2048, causal, one window; B, S, nh, nkv, window
FLASH_BWD_CASES = [(1, 1, 2, 2, 0), (2, 127, 4, 2, 0), (1, 200, 8, 1, 0), (1, 200, 4, 4, 37),
                   (1, 2048, 8, 1, 0), (1, 2048, 32, 4, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,nkv,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain(card, B, S, nh, nkv, window, hd, dtype):
    rng = np.random.default_rng(S + hd + nh)
    q = _randn(rng, (B, nh, S, hd), dtype, card)
    k, v = (_randn(rng, (B, nkv, S, hd), dtype, card) for _ in range(2))
    do = _randn(rng, (B, nh, S, hd), dtype, card)
    o = flash_attention(q, k, v, causal=True, window=window)
    before = kernels.flash_attention_bwd.launches
    got = kernels.flash_attention_bwd(q, k, v, o, do, causal=True, window=window)
    assert kernels.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                       causal=True, window=window)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == DTYPES[dtype] and g.shape == w.shape
        if S == 1 and i < 2:
            _bwd_gate(g, want[2].abs().max().item(), dtype, single_key=True)
        else:
            _bwd_gate(g, w, dtype)


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


@pytest.mark.cuda
def test_ssd_scan_refuses_grad_on_the_card(card):
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=card, requires_grad=True)
    args = (torch.zeros(1, 2, 64, device=card), -torch.ones(2, device=card),
            torch.zeros(1, 64, 64, dtype=torch.bfloat16, device=card),
            torch.zeros(1, 64, 64, dtype=torch.bfloat16, device=card))
    with pytest.raises(RuntimeError, match="SSD backward not ported"):
        ssd_scan(x, *args)
    with torch.no_grad():
        assert ssd_scan(x, *args).shape == x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("scale,layers", [("tiny", None), ("full", 2)])
def test_train_step_kernels_match_plain(card, scale, layers):
    """The gradients of one fp32 train step (G = 2) on the card through the
    kernels against the plain versions, from the same masters and batch:
    loss within 1e-5 and each gradient within 1e-3 relative L2. Tiny
    yi-6b, and full-width yi-6b cut to 2 layers; wq, wk, wv, wi, wg at
    fan-in H, as chip_smoke.py gates: under the reference's init attention
    is a hard argmax and two correct backwards differ by percents even in
    fp32 (PERF.md, ROADMAP §3)."""
    import dataclasses
    from repro_torch.train.data import DataCfg, SyntheticDataset
    from repro_torch.train.optim import OptimizerCfg
    from repro_torch.train.step import TrainCfg, accumulate_grads, init_train_state, sync_model

    arch = scale_arch(get_config("yi-6b"), scale)
    if layers:
        arch = dataclasses.replace(arch, num_layers=layers)
    cfg = TrainCfg(run=RunCfg(compute_dtype=torch.float32, remat=False), opt=OptimizerCfg(),
                   num_microbatches=2)
    S = 256 if scale == "tiny" else 1024
    batch = SyntheticDataset(arch, DataCfg(seq_len=S, global_batch=2, num_microbatches=2)) \
        .batch_at(0)
    state = init_train_state(arch, cfg, torch.Generator(device=card).manual_seed(0), card)
    with torch.no_grad():
        for name, master in state.params.items():
            if name.split(".")[-1] in ("wq", "wk", "wv", "wi", "wg"):
                master.mul_((arch.num_layers / arch.d_model) ** 0.5)
    sync_model(state)
    kernels.reset_launch_counts()
    gk, lk, _ = accumulate_grads(state.model, batch, cfg)
    counts = kernels.launch_counts()
    L = arch.num_layers
    assert counts == {"flash_attention": 2 * L, "flash_attention_bwd": 2 * L,
                      "rmsnorm": 2 * (2 * L + 1), "rmsnorm_bwd": 2 * (2 * L + 1), "ssd_scan": 0}
    with _plain_versions():
        gp, lp, _ = accumulate_grads(state.model, batch, cfg)
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for n in gk:
        rel = ((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3, (n, rel)


@contextlib.contextmanager
def _plain_versions():
    """The model's flash and RMSNorm calls through their plain versions."""
    saved = {n: getattr(kernels, n) for n in ("flash_attention", "rmsnorm")}
    try:
        kernels.flash_attention = ref.flash_attention_ref
        kernels.rmsnorm = ref.rmsnorm_ref
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,layers", [("tiny", None), ("full", 2)])
def test_train_grads_as_close_to_fp64_as_plain(card, scale, layers):
    """Under the reference's own init, where fp32 rounding alone moves the
    gradients by percents at full width (hard-argmax attention; PERF.md):
    the fp32 gradients of G = 2 microbatches through the kernels sit as
    close to fp64 of the same weights (plain versions) as the fp32 plain
    versions do: each leaf and the whole gradient within 1.5x the plain
    versions' relative L2 distance, or 1e-4. Tiny yi-6b, and full-width
    yi-6b cut to 2 layers, as chip_smoke.py gates."""
    import dataclasses
    from repro_torch.models.lm import LM
    from repro_torch.train.data import DataCfg, SyntheticDataset
    from repro_torch.train.step import TrainCfg, accumulate_grads

    arch = scale_arch(get_config("yi-6b"), scale)
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
