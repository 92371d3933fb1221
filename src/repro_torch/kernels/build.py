"""Build and load the port's CUDA kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process a source, all started together) and links them into one shared
library with a plain C interface under ``build/repro_torch/`` at the
repository root; the file name carries a hash of the sources, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ``ctypes``. Nothing here is built or loaded at
import time.

Each wrapper's forward and backward is one ``torch.library`` operator in
the ``repro_torch`` namespace (``define_op``; the rotary embedding's in
``repro_torch_pointwise``, see ``rope.py``): a CUDA implementation (the
launch), a CPU implementation (the plain version from ``ref.py``) and a
fake implementation for tensors without storage (the meta device, or a
``FakeTensorMode``). The fake implementation runs the CUDA path's checks
and allocates what the CUDA path allocates, outputs and scratch, and
launches nothing; ``launch.dryrun`` walks a model through it. Where the
CUDA path plans by the card's SM count, the fake path takes
``TARGET_SMS``, the count of the card the port is written for
(``chip_smoke.py`` holds it to the card).

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
from typing import Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

__all__ = ["library", "build", "check", "dtype_code", "stream_of", "sm_count", "refuse_dtensor",
           "define_op", "fake_impl", "address", "sms_of", "TARGET_NAME", "TARGET_SMS",
           "TARGET_MEMORY"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

# The card the port is written for, as torch.cuda.get_device_properties
# reads an H100 SXM: its name, its SMs and its device memory in bytes.
# A fake run plans and judges fit by these; chip_smoke.py checks them.
TARGET_NAME = "NVIDIA H100 80GB HBM3"
TARGET_SMS = 132
TARGET_MEMORY = 85_017_493_504

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)
SIGNATURES = {
    # name: (restype, argtypes)
    "rmsnorm_launch": (_I, [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P]),
    "rmsnorm_bwd_launch": (_I, [_P] * 6 + [_I, _I, ctypes.c_float, _I, _I, _I, _I, _P]),
    "rmsnorm_bwd_rows_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "flash_attention_wgmma_launch": (_I, [_P] * 5 + [_LL] + [_I] * 8 + [_P]),
    "flash_attention_mma_launch": (_I, [_P] * 5 + [_LL] + [_I] * 9 + [_P]),
    "flash_attention_bwd_delta_launch": (_I, [_P] * 3 + [_LL] + [_I] * 6 + [_P]),
    "flash_attention_bwd_launch": (_I, [_P] * 9 + [_LL] + [_I] * 9 + [_P]),
    "flash_attention_bwd_wgmma_launch": (_I, [_P] * 10 + [_LL] + [_I] * 9 + [_P]),
    "flash_attention_bwd_wgmma_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "flash_attention_wgmma_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "flash_attention_mma_info": (_I, [_I, _I, ctypes.POINTER(ctypes.c_int)]),
    "flash_attention_bwd_info": (_I, [_I, _I, ctypes.POINTER(ctypes.c_int)]),
    "ssd_scan_fma_launch": (_I, [_P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                                 _I, _I, _I, _I, _I, _I, _P]),
    "ssd_scan_wgmma_launch": (_I, [_P] * 11 + [ctypes.POINTER(ctypes.c_longlong),
                                               _I, _I, _I, _I, _I, _P]),
    "ssd_scan_wgmma_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "ssd_scan_bwd_launch": (_I, [_P] * 19 + [_LL] + [_I] * 6 + [_P]),
    "ssd_scan_bwd_info": (_I, [_I, _I, ctypes.POINTER(ctypes.c_int)]),
    "ssd_scan_bwd_wgmma_launch": (_I, [_P] * 20 + [_LL] + [_I] * 6 + [_P]),
    "ssd_scan_bwd_wgmma_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
    "rope_launch": (_I, [_P] * 6 + [_I] * 7 + [_P]),
    "chain_replay_launch": (_I, [_P, _I, _P, _I] + [_P] * 6 + [_I, _P]),
    "chain_replay_info": (_I, [_I, ctypes.POINTER(ctypes.c_int)]),
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
    """Compile the kernels if this source hash has no library yet: one nvcc
    a source file, run side by side, then one link. Returns (path, seconds
    spent compiling and linking, nvcc's output)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libreprotorch_{digest.hexdigest()[:16]}.so"
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objdir = BUILD_DIR / f"obj_{digest.hexdigest()[:16]}_{os.getpid()}"
    objdir.mkdir()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        jobs = [(src, objdir / f"{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in jobs]
        out = []
        for (src, _), proc in zip(jobs, procs):
            text = proc.communicate()[0]
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{text}")
            out.append(text)
        link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stderr}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a library
    return path, seconds, "".join(out)


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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _no_storage(t: torch.Tensor) -> bool:
    """Whether ``t`` has no memory behind it: a meta or a fake tensor."""
    return t.is_meta or isinstance(t, FakeTensor)


def address(t: torch.Tensor) -> int:
    """``t.data_ptr()``; for a fake tensor, its offset in bytes from its
    storage's base (a meta tensor's ``data_ptr`` is that offset already).
    The CUDA caching allocator aligns a base to 512 bytes, so the kernels'
    alignment checks read the same on all three."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def sms_of(t: torch.Tensor) -> int:
    """The SM count the kernels plan by: the card's for a CUDA tensor,
    ``TARGET_SMS`` for a tensor without storage."""
    return TARGET_SMS if _no_storage(t) else sm_count(t.device.index or 0)


_LIBS: Dict[str, torch.library.Library] = {}
_FAKE: Dict[Tuple[str, str], Callable] = {}


def define_op(name: str, schema: str, *, cuda: Callable, cpu: Callable, fake: Callable,
              namespace: str = "repro_torch"):
    """Define ``torch.ops.<namespace>.<name>`` with ``schema`` (the argument
    list and returns, e.g. ``"(Tensor x, float eps) -> Tensor"``): ``cuda``
    for CUDA tensors (the launch), ``cpu`` for CPU tensors (the plain
    version), ``fake`` for tensors without storage (the CUDA path's checks
    and allocations; no launch). Returns the op."""
    if namespace not in _LIBS:
        _LIBS[namespace] = torch.library.Library(namespace, "DEF")
    lib = _LIBS[namespace]
    lib.define(name + schema)
    lib.impl(name, cuda, "CUDA")
    lib.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{namespace}::{name}", fake, lib=lib)
    _FAKE[(namespace, name)] = fake
    return getattr(getattr(torch.ops, namespace), name)


def fake_impl(op) -> Optional[Callable]:
    """The fake implementation of an op ``define_op`` defined (an
    ``OpOverload``), or None for any other op."""
    return _FAKE.get((op.namespace, op.__name__.split(".")[0]))


def refuse_dtensor(op: str, *tensors) -> None:
    """Raise if any argument is a ``DTensor``: a kernel reads ``data_ptr()``
    and shapes, which on a DTensor are its local shard's and its global
    tensor's. A model on a mesh hands the kernels local tensors."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{op} takes plain tensors, got a DTensor: pass its local shard "
                        f"(.to_local())")
