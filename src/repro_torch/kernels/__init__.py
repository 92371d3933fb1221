"""Hand-written CUDA kernels of the port, one wrapper each.

Each kernel has three parts: ``csrc/<name>.cu`` (the CUDA kernel for
sm_90a), ``<name>.py`` (the wrapper: checks, allocation, launch, a
``launches`` counter) and its plain PyTorch version in ``ref.py``. A
wrapper dispatches on the tensor's device alone: CPU tensors take the
plain version, CUDA tensors the kernel, and anything else raises.
``flash_attention`` and ``rmsnorm`` are autograd Functions whose backward
is the wrapper ``flash_attention_bwd`` / ``rmsnorm_bwd`` (a kernel of its
own, counted under its own name).
"""

from typing import Dict

from . import ref
from .flash_attention import flash_attention, flash_attention_bwd
from .rmsnorm import rmsnorm, rmsnorm_bwd
from .ssd_scan import ssd_scan

__all__ = ["flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "ssd_scan", "ref",
           "KERNELS", "launch_counts", "reset_launch_counts"]

KERNELS = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
           "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd, "ssd_scan": ssd_scan}


def launch_counts() -> Dict[str, int]:
    """Kernel launches (CUDA tensors only) since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
