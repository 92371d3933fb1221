"""Weights between the reference's parameter tree and the port's ``LM``.

The reference's ``init_params`` returns a nested dict whose per-layer
leaves are stacked on a leading layer axis (``tree["layers"]["attn"]["wq"]``
is [L,H,nh*hd]); the port holds one ``Block`` per layer
(``blocks.<i>.attn.wq`` is [H,nh*hd]). Both use the same tree paths and
the same [in,out] layouts, so converting is slicing, never transposing.
Arrays cross as numpy: this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .configs.base import ArchConfig
from .models.lm import LM, RunCfg

__all__ = ["params_from_numpy", "params_to_numpy"]


def _tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``blocks.3.attn.wq`` -> (("layers", "attn", "wq"), 3); ``embed`` ->
    (("embed",), None)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("layers", *parts[2:]), int(parts[1])
    return tuple(parts), None


def _leaf_paths(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


@torch.no_grad()
def params_from_numpy(tree: Dict, arch: ArchConfig, cfg: RunCfg = RunCfg(),
                      device=None) -> LM:
    """Build an ``LM`` from the reference's parameter tree (numpy leaves, or
    anything ``np.asarray`` takes). Weights are cast to ``cfg.compute_dtype``."""
    model = LM(arch, cfg, device)
    params = dict(model.named_parameters())
    want = {_tree_path(n)[0] for n in params}
    have = set(_leaf_paths(tree))
    if want != have:
        raise ValueError(f"tree leaves differ from the model's: missing {sorted(want - have)}, "
                         f"unexpected {sorted(have - want)}")
    for name, p in params.items():
        path, layer = _tree_path(name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        a = np.asarray(leaf)
        if layer is not None:
            a = a[layer]
        if a.shape != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: tree has {a.shape}, model wants {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model


@torch.no_grad()
def params_to_numpy(model: LM) -> Dict:
    """The inverse of ``params_from_numpy``: a nested dict of float32 numpy
    arrays, per-layer leaves stacked on a leading layer axis."""
    per_layer: Dict[Tuple[str, ...], list] = {}
    tree: Dict = {}
    for name, p in model.named_parameters():
        path, layer = _tree_path(name)
        a = p.detach().float().cpu().numpy()
        if layer is None:
            _put(tree, path, a)
        else:
            per_layer.setdefault(path, []).append(a)
    for path, arrays in per_layer.items():
        _put(tree, path, np.stack(arrays))
    return tree


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
