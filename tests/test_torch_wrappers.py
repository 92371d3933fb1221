"""What the kernel wrappers decide in Python, on CPU tensors: which CUDA
kernel serves a (dtype, head_dim) or (dtype, H), and which layouts, strides
and addresses the kernels take. The kernels themselves run only on a card
(tests/test_torch_cuda.py); these checks are the same code that guards them
there."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (LSE_ROWS, WGMMA_HEAD_DIMS,  # noqa: E402
                                                 bwd_slices, lse_stride)
from repro_torch.kernels.flash_attention import bwd_kernel_path as flash_bwd_path  # noqa: E402
from repro_torch.kernels.flash_attention import check_args as flash_check  # noqa: E402
from repro_torch.kernels.flash_attention import check_bwd_args as flash_bwd_check  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_path as flash_path  # noqa: E402
from repro_torch.kernels.rmsnorm import BWD_MAX_H, BWD_ROW_GROUPS, ROW_VPL  # noqa: E402
from repro_torch.kernels.rmsnorm import bwd_grid as rmsnorm_bwd_grid  # noqa: E402
from repro_torch.kernels.rmsnorm import bwd_kernel_path as rmsnorm_bwd_path  # noqa: E402
from repro_torch.kernels.rmsnorm import check_args as rmsnorm_check  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel_path as rmsnorm_path  # noqa: E402
from repro_torch.kernels.rope import check_args as rope_check  # noqa: E402
from repro_torch.kernels.ssd_scan import (BWD_WGMMA_STATE_DIMS, HEAD_DIMS,  # noqa: E402
                                          SCAN_COST, STATE_DIMS, WGMMA_STATE_DIMS,
                                          segment_chunks)
from repro_torch.kernels.ssd_scan import bwd_kernel_path as ssd_bwd_path  # noqa: E402
from repro_torch.kernels.ssd_scan import bwd_plan  # noqa: E402
from repro_torch.kernels.ssd_scan import check_args as ssd_check  # noqa: E402
from repro_torch.kernels.ssd_scan import check_bwd_args as ssd_bwd_check  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel_path as ssd_path  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


def _qkv(B=2, S=40, nh=8, nkv=2, hd=128, dtype=BF16):
    return (torch.zeros(B, nh, S, hd, dtype=dtype), torch.zeros(B, nkv, S, hd, dtype=dtype),
            torch.zeros(B, nkv, S, hd, dtype=dtype))


@pytest.mark.parametrize("dtype,hd,path", [
    (BF16, 64, "wgmma"), (BF16, 80, "wgmma"), (BF16, 128, "wgmma"), (BF16, 192, "wgmma"),
    (BF16, 32, "mma"), (F32, 32, "mma"), (F32, 64, "mma"), (F32, 80, "mma"), (F32, 128, "mma"),
    (F32, 192, "mma")])
def test_flash_dispatch_by_dtype_and_head_dim(dtype, hd, path):
    assert flash_path(dtype, hd) == path
    assert flash_check(*_qkv(hd=hd, dtype=dtype), 0) == path


@pytest.mark.parametrize("hd", [16, 48, 96, 224, 256])
def test_flash_rejects_head_dims_no_kernel_has(hd):
    with pytest.raises(ValueError, match="head_dim"):
        flash_path(BF16, hd)
    with pytest.raises(ValueError, match="head_dim"):
        flash_check(*_qkv(hd=hd), 0)


def test_flash_rejects_other_dtypes():
    with pytest.raises(TypeError):
        flash_check(*_qkv(hd=64, dtype=torch.float16), 0)
    q, k, v = _qkv()
    with pytest.raises(TypeError, match="share a dtype"):
        flash_check(q, k.float(), v, 0)


@pytest.mark.parametrize("hd", [64, 80, 128, 192])
def test_flash_takes_the_models_strided_views(hd):
    """layers.attention passes [B,S,nh,hd] tensors as [B,nh,S,hd] views."""
    B, S, nh, nkv = 2, 40, 8, 2
    q = torch.zeros(B, S, nh, hd, dtype=BF16).transpose(1, 2)
    k, v = (torch.zeros(B, S, nkv, hd, dtype=BF16).transpose(1, 2) for _ in range(2))
    assert not q.is_contiguous()
    assert flash_check(q, k, v, 0) == "wgmma"


def test_flash_takes_a_16_byte_aligned_offset_base():
    n = 2 * 8 * 40 * 64
    q = torch.zeros(n + 8, dtype=BF16)[8:].view(2, 8, 40, 64)   # 16 bytes into the buffer
    _, k, v = _qkv(hd=64)
    assert flash_check(q, k, v, 0) == "wgmma"


def test_flash_rejects_strides_that_are_not_multiples_of_16_bytes():
    """TMA takes only strides that are multiples of 16 bytes: rows of
    65 bf16 values (130 bytes) are refused."""
    q = torch.zeros(2, 8, 40, 65, dtype=BF16)[..., :64]
    _, k, v = _qkv(hd=64)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash_check(q, k, v, 0)
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_check(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, 0)


def test_flash_rejects_a_misaligned_base():
    n = 2 * 8 * 40 * 64
    q = torch.zeros(n + 1, dtype=BF16)[1:].view(2, 8, 40, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    _, k, v = _qkv(hd=64)
    with pytest.raises(ValueError, match="aligned base"):
        flash_check(q, k, v, 0)


def test_flash_rejects_shapes_and_windows_that_do_not_fit():
    q, k, v = _qkv(nh=6, nkv=4)
    with pytest.raises(ValueError, match="do not fit"):
        flash_check(q, k, v, 0)                         # 6 heads over 4 kv heads
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="do not fit"):
        flash_check(q, k[:, :, :20], v[:, :, :20], 0)   # kv shorter than q
    with pytest.raises(ValueError, match="window"):
        flash_check(q, k, v, -1)


@pytest.mark.parametrize("dtype,H,path", [
    (BF16, 2560, "rows"), (BF16, 4096, "rows"), (BF16, 5120, "rows"), (BF16, 256, "loop"),
    (BF16, 8, "loop"), (BF16, 8200, "loop"), (BF16, 1600, "loop"), (BF16, 3072, "loop"),
    (F32, 4096, "loop"), (F32, 8, "loop")])
def test_rmsnorm_dispatch_by_dtype_and_width(dtype, H, path):
    assert rmsnorm_path(dtype, H) == path
    assert rmsnorm_check(torch.zeros(4, H, dtype=dtype), torch.zeros(H, dtype=dtype)) == path


def test_rmsnorm_register_widths_are_the_instantiated_ones():
    """ROW_VPL lists exactly the cases of rmsnorm_launch's switch."""
    src = (CSRC / "rmsnorm.cu").read_text()
    cases = [int(v) for v in re.findall(r"case (\d+): return launch_rows<(?:\d+)>", src)]
    assert tuple(cases) == ROW_VPL


def test_rmsnorm_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm_check(torch.zeros(4, 12), torch.zeros(12))
    with pytest.raises(TypeError):
        rmsnorm_check(torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8, dtype=torch.float16))
    with pytest.raises(TypeError):
        rmsnorm_check(torch.zeros(4, 8), torch.zeros(8, dtype=BF16))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_check(torch.zeros(8, 4).t(), torch.zeros(8))
    with pytest.raises(ValueError, match="x \\[T,H\\]"):
        rmsnorm_check(torch.zeros(4, 8), torch.zeros(16))
    x = torch.zeros(4 * 16 + 1, dtype=BF16)[1:].view(4, 16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        rmsnorm_check(x, torch.ones(16, dtype=BF16))


def _ssd(B=2, nh=4, S=130, hp=64, N=128, dtype=BF16, views=False):
    """x [B,nh,S,hp], dt [B,nh,S], A [nh], Bm/Cm [B,S,N]; with ``views`` in
    the model's layout: x, Bm, Cm column slices of one [B,S,nh*hp+2N]
    buffer (mamba2-2.7b's row of 5,376 values at nh 80), dt a view of
    [B,S,nh]."""
    if views:
        buf = torch.zeros(B, S, nh * hp + 2 * N, dtype=dtype)
        x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
        Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
        dt = torch.zeros(B, S, nh).transpose(1, 2)
    else:
        x = torch.zeros(B, nh, S, hp, dtype=dtype)
        Bm, Cm = torch.zeros(B, S, N, dtype=dtype), torch.zeros(B, S, N, dtype=dtype)
        dt = torch.zeros(B, nh, S)
    return x, dt, -torch.ones(nh), Bm, Cm


@pytest.mark.parametrize("dtype,hp,N,path", [
    (BF16, 64, 128, "wgmma"), (BF16, 64, 64, "wgmma"), (BF16, 64, 16, "wgmma"), (BF16, 64, 32, "fma"),
    (BF16, 32, 128, "fma"), (BF16, 16, 64, "fma"), (F32, 64, 128, "fma"), (F32, 64, 64, "fma"),
    (F32, 32, 16, "fma")])
def test_ssd_dispatch_by_dtype_and_shape(dtype, hp, N, path):
    """bf16 at hp 64 and N 16/64/128 (hymba-1.5b, mamba2-2.7b) takes the
    wgmma kernel; fp32 and every other bf16 shape the FMA kernel."""
    assert ssd_path(dtype, hp, N) == path
    assert ssd_check(*_ssd(hp=hp, N=N, dtype=dtype)) == path
    assert (path == "wgmma") == (dtype == BF16 and hp == 64 and N in WGMMA_STATE_DIMS)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hp", HEAD_DIMS)
@pytest.mark.parametrize("N", STATE_DIMS)
def test_ssd_bwd_dispatch_by_dtype_and_shape(dtype, hp, N):
    """The backward's routing for every (dtype, hp, N) a kernel is
    instantiated for: bf16 at hp 64 and N 16/64/128 takes the wgmma
    backward (csrc/ssd_scan_bwd_wgmma.cu), as its forward takes the wgmma
    scan; fp32 and every other bf16 shape take the FMA backward
    (csrc/ssd_scan_bwd.cu), as its forward takes the FMA scan.
    check_bwd_args names the same path, the model's views included."""
    path = "wgmma" if dtype == BF16 and hp == 64 and N in (16, 64, 128) else "fma"
    assert ssd_bwd_path(dtype, hp, N) == path
    assert ssd_path(dtype, hp, N) == path
    for views in (False, True):
        x, dt, A, Bm, Cm = _ssd(hp=hp, N=N, dtype=dtype, views=views)
        dy = torch.zeros_like(x)
        assert ssd_bwd_check(x, dt, A, Bm, Cm, dy) == path


@pytest.mark.parametrize("hp,N", [(48, 64), (128, 64), (64, 8), (64, 256)])
def test_ssd_rejects_shapes_no_kernel_has(hp, N):
    with pytest.raises(ValueError, match="hp in .* and N in"):
        ssd_path(BF16, hp, N)
    with pytest.raises(ValueError, match="instantiated"):
        ssd_check(*_ssd(hp=hp, N=N))


def test_ssd_rejects_other_dtypes():
    with pytest.raises(TypeError):
        ssd_path(torch.float16, 64, 128)
    x, dt, A, Bm, Cm = _ssd()
    with pytest.raises(TypeError, match="share a dtype"):
        ssd_check(x, dt, A, Bm.float(), Cm)
    with pytest.raises(TypeError, match="float32"):
        ssd_check(x, dt.to(BF16), A, Bm, Cm)


# mamba2-2.7b's 80 SSM heads and a rank's share of them where its mixer is
# head parallel over a 2-, 4-, 8-, 16- or 80-way "model" axis
SHARD_HEADS = [4, 80, 40, 20, 10, 5, 1]


@pytest.mark.parametrize("nh", SHARD_HEADS)
def test_ssd_takes_the_models_strided_views(nh):
    """layers.ssd_scan passes x, Bm, Cm as slices of the conv output and dt
    as a [B,nh,S] view: rows of nh*64 + 256 values, Bm and Cm at element
    offsets nh*64 and nh*64 + 128, all multiples of 16 bytes; on a
    head-parallel mesh nh is the rank's heads, the conv output its
    [x_r | B | C] columns."""
    x, dt, A, Bm, Cm = _ssd(nh=nh, views=True)
    assert not (x.is_contiguous() or Bm.is_contiguous())
    assert nh == 1 or not dt.is_contiguous()       # a [B,1,S] view is contiguous
    assert x.stride(2) * 2 % 16 == 0 and (Bm.data_ptr() - x.data_ptr()) % 16 == 0
    assert ssd_check(x, dt, A, Bm, Cm) == "wgmma"


@pytest.mark.parametrize("nh", SHARD_HEADS)
def test_ssd_bwd_takes_a_shards_heads(nh):
    """The backward's checks and its wgmma plan at mamba2-2.7b's training
    shape (B 1, S 2048, N 128, 132 SMs) for a rank's heads: the model's
    views, dy like x, a head group of at most nh heads, and the forward's
    segment plan."""
    x, dt, A, Bm, Cm = _ssd(B=1, nh=nh, S=2048, views=True)
    assert ssd_bwd_check(x, dt, A, Bm, Cm, torch.zeros_like(x)) == "wgmma"
    seg, group = bwd_plan(1, nh, 2048, 132)
    assert seg >= 1 and 1 <= group <= nh
    assert segment_chunks(1, nh, 2048, 132) >= 1


def test_ssd_rejects_unaligned_views():
    """Rows or bases off 16 bytes (TMA takes neither), and a strided last dim."""
    B, nh, S = 1, 2, 40
    buf = torch.zeros(B, S, nh * 64 + 2 * 128 + 1, dtype=BF16)
    x = buf[..., 1:1 + nh * 64].view(B, S, nh, 64).transpose(1, 2)     # rows of 642 bytes
    _, dt, A, Bm, Cm = _ssd(B=B, nh=nh, S=S)
    with pytest.raises(ValueError, match="aligned"):
        ssd_check(x, dt, A, Bm, Cm)
    off = torch.zeros(B * S * 128 + 1, dtype=BF16)[1:].view(B, S, 128)   # base 2 bytes off
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    x, dt, A, Bm, Cm = _ssd(B=B, nh=nh, S=S)
    with pytest.raises(ValueError, match="aligned"):
        ssd_check(x, dt, A, off, Cm)
    with pytest.raises(ValueError, match="unit last stride"):
        ssd_check(x, dt, A, Bm, Cm.transpose(1, 2).contiguous().transpose(1, 2))


def test_ssd_state_options_need_the_wgmma_path():
    """initial_state / return_state are served by the wgmma path only
    (hymba-1.5b's N 16 among its shapes, in the model's views too); on the
    FMA path they raise, as does an initial state of the wrong shape or
    type."""
    for dtype, N in ((F32, 128), (F32, 16), (BF16, 32)):
        x, dt, A, Bm, Cm = _ssd(N=N, dtype=dtype)
        with pytest.raises(ValueError, match="wgmma path only"):
            ssd_check(x, dt, A, Bm, Cm, torch.zeros(2, 4, 64, N))
        with pytest.raises(ValueError, match="wgmma path only"):
            ssd_check(x, dt, A, Bm, Cm, None, True)
    for N in WGMMA_STATE_DIMS:
        for views in (False, True):
            x, dt, A, Bm, Cm = _ssd(N=N, views=views)
            assert ssd_check(x, dt, A, Bm, Cm, torch.zeros(2, 4, 64, N), True) == "wgmma"
            assert ssd_check(x, dt, A, Bm, Cm, None, True) == "wgmma"
    x, dt, A, Bm, Cm = _ssd()
    with pytest.raises(ValueError, match="initial_state"):
        ssd_check(x, dt, A, Bm, Cm, torch.zeros(2, 4, 128, 64))
    with pytest.raises(ValueError, match="initial_state"):
        ssd_check(x, dt, A, Bm, Cm, torch.zeros(2, 4, 64, 128, dtype=BF16))


@pytest.mark.parametrize("B,nh,S,sms,N,want", [
    (2, 80, 2000, 132, 128, 11),   # mamba2-2.7b prefill: 3 segments, 480 CTAs in 2 waves
    (1, 80, 2000, 132, 128, 11),   # 3 segments, 240 CTAs in one wave
    (2, 80, 64, 132, 128, 1),      # one chunk: one segment
    (1, 2, 2000, 132, 128, 8),     # few heads: 4 segments
    (8, 80, 2000, 132, 128, 16),   # many heads: 2 segments
    (2, 80, 640, 132, 128, 10),    # 10 chunks: one wave of 160 CTAs, no split
    (2, 80, 2000, 132, 64, 11),    # N 64 shares N 128's costs
    (2, 50, 2000, 132, 16, 7),     # hymba-1.5b prefill (SCAN_COST[16]): 5 segments, 500 CTAs
    (1, 50, 2048, 132, 16, 7)])    # hymba-1.5b training: 5 segments, 250 CTAs
def test_ssd_segment_chunks(B, nh, S, sms, N, want):
    assert segment_chunks(B, nh, S, sms, N) == want
    if N == 128:                   # mamba2-2.7b's plans: N 128 is the default
        assert segment_chunks(B, nh, S, sms) == want


def test_ssd_wgmma_state_dims_are_the_instantiated_ones():
    """WGMMA_STATE_DIMS lists exactly the N that ssd_scan_wgmma_launch takes,
    BWD_WGMMA_STATE_DIMS those of ssd_scan_bwd_wgmma_launch; SCAN_COST has
    a cost model for each, whose CTAs an SM are the scan's launch bounds."""
    src = (CSRC / "ssd_scan.cu").read_text()
    assert "N == 128 ? launch<128>(tx, tb, tc, p, s) : launch<64>(tx, tb, tc, p, s)" in src
    assert "if (N == 16) return launch<16>(tx, tb, tc, p, s);" in src
    assert "(N != 16 && N != 64 && N != 128)" in src
    assert WGMMA_STATE_DIMS == (16, 64, 128)
    assert "__launch_bounds__(kThreads, 2)\nssd_chunk_scan_kernel(" in src
    assert sorted(SCAN_COST) == sorted(WGMMA_STATE_DIMS)
    assert all(c["ctas"] == 2 for c in SCAN_COST.values())
    bwd = (CSRC / "ssd_scan_bwd_wgmma.cu").read_text()
    assert "(N != 16 && N != 64 && N != 128)" in bwd
    assert "if (N == 16) return launch<16>(tx, tdy, tb, tc, p, s);" in bwd
    assert BWD_WGMMA_STATE_DIMS == (16, 64, 128)


# ---------------------------------------------------------------- backward routing

@pytest.mark.parametrize("dtype,hd,path", [
    (BF16, 64, "wgmma"), (BF16, 80, "wgmma"), (BF16, 128, "wgmma"), (BF16, 192, "wgmma"),
    (BF16, 32, "mma"), (F32, 32, "mma"), (F32, 64, "mma"), (F32, 80, "mma"), (F32, 128, "mma"),
    (F32, 192, "mma")])
def test_flash_bwd_dispatch_by_dtype_and_head_dim(dtype, hd, path):
    """bf16 at hd 64/80/128/192 (yi-6b, hymba-1.5b, hubert-xlarge,
    nemotron-4-340b) takes the wgmma + TMA backward;
    fp32 and bf16 hd 32 the mma.sync / FMA one; ``check_bwd_args`` says so."""
    assert flash_bwd_path(dtype, hd) == path
    q, k, v = _qkv(hd=hd, dtype=dtype)
    assert flash_bwd_check(q, k, v, torch.zeros_like(q), torch.zeros_like(q), 0) == path


@pytest.mark.parametrize("hd", [16, 96, 224])
def test_flash_bwd_rejects_head_dims_no_kernel_has(hd):
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd_path(BF16, hd)


def test_flash_bwd_head_dims_are_the_instantiated_ones():
    """The wgmma backward takes exactly WGMMA_HEAD_DIMS, each a case of an
    exhaustive switch (any other head dim returns an error); the mma
    backward instantiates bf16 only at hd 32."""
    assert WGMMA_HEAD_DIMS == (64, 80, 128, 192)
    for name, fn in (("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_launch"),
                     ("flash_attention", "flash_attention_wgmma_launch")):
        src = (CSRC / f"{name}.cu").read_text()
        entry = src[src.index(f'extern "C" int {fn}('):]
        switch = entry[entry.index("switch (hd)"):entry.index("default: return")]
        cases = re.findall(r"case (\d+): return launch<(\d+)>", switch)
        assert [int(a) for a, _ in cases] == list(WGMMA_HEAD_DIMS), name
        assert all(a == b for a, b in cases), name
    mma = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "dtype == kBFloat16 && hd == 32" in mma
    assert "flash_bwd_stats" not in mma + src


@pytest.mark.parametrize("group,kv_items,sms,want", [
    (8, 64, 132, 4),       # yi-6b training, S 2048: 16 kv tiles x 4 kv heads -> 256 items
    (8, 256, 132, 1),      # B 4: 256 kv items are enough unsplit
    (8, 128, 132, 2),
    (5, 80, 132, 5),       # hymba-1.5b, S 2048: 16 x 5 kv heads, group 5
    (1, 10, 132, 1),       # no GQA: nothing to split
    (6, 60, 132, 6)])      # 2 and 3 are not enough: the whole group
def test_flash_bwd_slices(group, kv_items, sms, want):
    got = bwd_slices(group, kv_items, sms)
    assert got == want and group % got == 0


@pytest.mark.parametrize("S,ld", [(1, 128), (127, 128), (128, 128), (129, 256), (2000, 2048)])
def test_flash_lse_stride(S, ld):
    """LSE and D rows are padded to whole 128-row tiles (16-byte aligned
    for the bulk copies)."""
    assert lse_stride(S) == ld


def test_flash_lse_rows_match_the_kernels_constant():
    src = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert "ld % 128 != 0" in src and LSE_ROWS == 128


@pytest.mark.parametrize("dtype,H,path,fwd", [
    (BF16, 2560, "rows", "rows"), (BF16, 4096, "rows", "rows"), (BF16, 5120, "rows", "rows"),
    (BF16, 1536, "rows", "loop"), (BF16, 1600, "rows", "loop"), (BF16, 3200, "rows", "loop"),
    (BF16, 3072, "loop", "loop"), (BF16, 12288, "loop", "loop"), (F32, 4096, "loop", "loop"),
    (F32, 1536, "loop", "loop"), (F32, 1600, "loop", "loop"), (F32, 3200, "loop", "loop"),
    (F32, 8, "loop", "loop")])
def test_rmsnorm_bwd_dispatch_by_dtype_and_width(dtype, H, path, fwd):
    """The backward holds a bf16 row in registers at its own widths, every
    width the models train at; the forward keeps its loop version at 1536,
    1600 and 3200, and fp32 takes the loop version both ways."""
    assert rmsnorm_bwd_path(dtype, H) == path
    assert rmsnorm_path(dtype, H) == fwd


def test_rmsnorm_bwd_rejects_rows_wider_than_its_shared_memory():
    assert rmsnorm_bwd_path(F32, BWD_MAX_H) == "loop"
    with pytest.raises(ValueError, match="up to"):
        rmsnorm_bwd_path(F32, BWD_MAX_H + 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm_bwd_path(BF16, 12)


@pytest.mark.parametrize("path,T,H,sms,want", [
    ("rows", 2048, 4096, 132, (132, 16)),    # yi-6b training: one partial row an SM
    ("rows", 7, 4096, 132, (2, 16)),         # a group of 4 warps a row, at most
    ("rows", 1, 2560, 132, (1, 16)),
    ("rows", 2048, 1600, 132, (132, 32)),    # hymba-1.5b: 8 row groups a CTA
    ("rows", 2048, 1536, 132, (132, 32)),    # granite-moe
    ("rows", 9, 1536, 132, (2, 32)),
    ("rows", 2048, 3200, 132, (132, 16)),    # hymba-1.5b's ssm_norm: 4 row groups
    ("loop", 300, 1000, 132, (75, 4)),       # 4 warps a block where 4 slices fit
    ("loop", 4096, 12288, 132, (264, 1)),    # wide rows: one warp a block, 2 blocks an SM
    ("loop", 2048, 4096, 132, (264, 4))])
def test_rmsnorm_bwd_grid(path, T, H, sms, want):
    assert rmsnorm_bwd_grid(path, T, H, sms) == want


def test_rmsnorm_bwd_register_widths_are_the_instantiated_ones():
    """The register backward instantiates exactly the BWD_ROW_GROUPS widths,
    each with its row groups a CTA, in the launch and in the resource query;
    its widths hold the forward's ROW_VPL widths and the three it keeps on
    the loop version."""
    src = (CSRC / "rmsnorm_bwd.cu").read_text()
    launched = re.findall(r"case (\d+): e = launch_rows<(\d+), (\d+)>", src)
    queried = re.findall(r"case (\d+): return rows_info<(\d+), (\d+)>", src)
    for cases in (launched, queried):
        assert all(h == h2 for h, h2, _ in cases)
        assert {int(h): int(g) for h, _, g in cases} == BWD_ROW_GROUPS
    assert set(BWD_ROW_GROUPS) == {256 * v for v in ROW_VPL} | {1536, 1600, 3200}


# ------------------------------------------------------------------ DTensor arguments

@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A (1, 1) ("data", "model") CPU mesh over a one-rank gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", rank=0, world_size=1, store=store)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _dtensor_calls():
    """(name, call(as_dtensor)) for every wrapper and named check: each
    call passes its first tensor argument through ``as_dtensor``."""
    from repro_torch import kernels
    from repro_torch.kernels.ssd_scan import _check_rows
    q, k, v = _qkv(B=1, S=16, nh=2, nkv=1, hd=32, dtype=F32)
    lse = torch.zeros(1, 2, 16)
    x, w = torch.zeros(4, 64), torch.ones(64)
    sx, sdt, sA = torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16), -torch.ones(2)
    sB = torch.zeros(1, 16, 16)
    rq, rk, rt = torch.zeros(1, 16, 2, 32), torch.zeros(1, 16, 1, 32), torch.zeros(1, 16, 16)
    return [
        ("flash_attention", lambda d: kernels.flash_attention(d(q), k, v)),
        ("flash_attention_bwd", lambda d: kernels.flash_attention_bwd(d(q), k, v, q, q, lse)),
        ("flash check_args", lambda d: flash_check(d(q), k, v, 0)),
        ("flash check_bwd_args", lambda d: flash_bwd_check(q, k, v, d(q), q, 0)),
        ("rmsnorm", lambda d: kernels.rmsnorm(d(x), w)),
        ("rmsnorm_bwd", lambda d: kernels.rmsnorm_bwd(d(x), w, x)),
        ("rmsnorm check_args", lambda d: rmsnorm_check(d(x), w)),
        ("ssd_scan", lambda d: kernels.ssd_scan(d(sx), sdt, sA, sB, sB)),
        ("ssd_scan_bwd", lambda d: kernels.ssd_scan_bwd(d(sx), sdt, sA, sB, sB, sx)),
        ("ssd _check_rows", lambda d: _check_rows("x", d(sx))),
        ("rope", lambda d: kernels.rope(d(rq), rk, rt, rt)),
        ("rope_bwd", lambda d: kernels.rope_bwd(d(rq), rk, rt, rt)),
        ("rope check_args", lambda d: rope_check(d(rq), rk, rt, rt)),
    ]


@pytest.mark.parametrize("case", range(13), ids=[n for n, _ in _dtensor_calls()])
def test_wrappers_refuse_dtensors(one_rank_mesh, case):
    """A DTensor would launch a kernel on its local shard under its global
    shape: every wrapper and named check raises on one, before it looks at
    the device (so here, on the CPU, too)."""
    from torch.distributed.tensor import DTensor, Replicate
    name, call = _dtensor_calls()[case]
    as_dtensor = lambda t: DTensor.from_local(t, one_rank_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        call(as_dtensor)
    call(lambda t: t)               # the same call on plain tensors passes
