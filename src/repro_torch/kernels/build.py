"""Build and load the port's CUDA kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface under ``build/repro_torch/`` at
the repository root; the file name carries a hash of the sources, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ``ctypes``. Nothing here runs at import time.

There is no ``-lcuda``: the one driver call the kernels need,
``cuTensorMapEncodeTiled`` (the TMA maps of the flash and SSD kernels), is
looked up through the runtime's ``cudaGetDriverEntryPoint``
(``csrc/hopper.cuh``). No CUTLASS headers
are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "build", "check", "dtype_code", "stream_of"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # name: (restype, argtypes)
    "rmsnorm_launch": (_I, [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P]),
    "flash_attention_wgmma_launch": (_I, [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                                          _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_attention_mma_launch": (_I, [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                                        _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "ssd_scan_fma_launch": (_I, [_P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                                 _I, _I, _I, _I, _I, _I, _P]),
    "ssd_scan_wgmma_launch": (_I, [_P] * 11 + [ctypes.POINTER(ctypes.c_longlong),
                                               _I, _I, _I, _I, _I, _P]),
    "ssd_scan_wgmma_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def build():
    """Compile the kernels if this source hash has no library yet.
    Returns (path, seconds spent compiling, nvcc's output)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libreprotorch_{digest.hexdigest()[:16]}.so"
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a library
    return path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        msg = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
