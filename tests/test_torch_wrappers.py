"""What the kernel wrappers decide in Python, on CPU tensors: which CUDA
kernel serves a (dtype, head_dim) or (dtype, H), and which layouts, strides
and addresses the kernels take. The kernels themselves run only on a card
(tests/test_torch_cuda.py); these checks are the same code that guards them
there."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import check_args as flash_check  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_path as flash_path  # noqa: E402
from repro_torch.kernels.rmsnorm import ROW_VPL  # noqa: E402
from repro_torch.kernels.rmsnorm import check_args as rmsnorm_check  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel_path as rmsnorm_path  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


def _qkv(B=2, S=40, nh=8, nkv=2, hd=128, dtype=BF16):
    return (torch.zeros(B, nh, S, hd, dtype=dtype), torch.zeros(B, nkv, S, hd, dtype=dtype),
            torch.zeros(B, nkv, S, hd, dtype=dtype))


@pytest.mark.parametrize("dtype,hd,path", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "mma"),
    (F32, 32, "mma"), (F32, 64, "mma"), (F32, 128, "mma")])
def test_flash_dispatch_by_dtype_and_head_dim(dtype, hd, path):
    assert flash_path(dtype, hd) == path
    assert flash_check(*_qkv(hd=hd, dtype=dtype), 0) == path


@pytest.mark.parametrize("hd", [16, 80, 96, 192, 256])
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


@pytest.mark.parametrize("hd", [64, 128])
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
