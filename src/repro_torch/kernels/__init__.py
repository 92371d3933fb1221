"""Hand-written CUDA kernels of the port, one wrapper each.

Each kernel has three parts: ``csrc/<name>.cu`` (the CUDA kernel for
sm_90a), ``<name>.py`` (the wrapper: checks, allocation, launch, a
``launches`` counter) and its plain PyTorch version in ``ref.py``. A
wrapper dispatches on the tensor's device alone: CPU tensors take the
plain version, CUDA tensors the kernel, tensors without storage (meta,
fake) the CUDA path's checks and allocations, and any other device
raises.
``flash_attention``, ``rmsnorm`` and ``ssd_scan`` are autograd Functions
whose backward is the wrapper ``flash_attention_bwd`` / ``rmsnorm_bwd`` /
``ssd_scan_bwd`` (a kernel of its own, counted under its own name).
``rope`` rotates a layer's q and k in one launch, with ``rope_bwd`` as its
backward; the two are counted apart from the others (``POINTWISE``, not
``KERNELS`` or ``launch_counts``) and their op is
``torch.ops.repro_torch_pointwise.rope``.
``chain_replay`` is the simulator's batched chain replay
(``repro_torch.core.fastbatch``), fp64 and not differentiable.
Each forward and backward is one ``torch.library`` op,
``torch.ops.repro_torch.<name>`` (``build.define_op``), which picks the
launch, the plain version or, for meta and fake tensors, a fake
implementation (the CUDA path's checks and allocations) by the tensors'
dispatch key; launches are counted in the CUDA implementation only.
"""

from typing import Dict

from . import ref
from .chain_replay import chain_replay
from .flash_attention import flash_attention, flash_attention_bwd
from .rmsnorm import rmsnorm, rmsnorm_bwd
from .rope import rope, rope_bwd
from .ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "rope", "rope_bwd",
           "ssd_scan", "ssd_scan_bwd", "chain_replay", "ref", "KERNELS", "POINTWISE",
           "launch_counts", "reset_launch_counts"]

KERNELS = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
           "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd, "ssd_scan": ssd_scan,
           "ssd_scan_bwd": ssd_scan_bwd, "chain_replay": chain_replay}
# kernels kept out of KERNELS and launch_counts (rope.py says why)
POINTWISE = {"rope": rope, "rope_bwd": rope_bwd}


def launch_counts() -> Dict[str, int]:
    """Kernel launches (CUDA tensors only) since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *POINTWISE.values()):
        fn.launches = 0
