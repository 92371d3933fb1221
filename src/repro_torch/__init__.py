"""PyTorch/CUDA port of the ``repro`` model substrate.

Module paths mirror ``repro`` (``repro_torch.models.layers`` is the
counterpart of ``repro.models.layers``). The port imports ``torch`` and
numpy only, never ``jax`` or ``repro``. Entry points run on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises: the
    port never carries on on the CPU unless it was asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
