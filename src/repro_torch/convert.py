"""Weights between the reference's parameter tree and the port's ``LM``.

The reference's ``init_params`` returns a nested dict whose per-layer
leaves are stacked on a leading layer axis (``tree["layers"]["attn"]["wq"]``
is [L,H,nh*hd]); the port holds one ``Block`` per layer
(``blocks.<i>.attn.wq`` is [H,nh*hd]). Both use the same tree paths and
the same [in,out] layouts, so converting is slicing, never transposing.
Arrays cross as numpy: this module imports no JAX.

The train state crosses the same way (``train_state_to_numpy`` /
``train_state_from_numpy``): the masters as the reference's ``params``
tree and the optimizer state as its ``{"m": tree, "v": tree, "step"}``,
which is what the two packages' checkpoints hold.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .configs.base import ArchConfig
from .models.lm import LM, RunCfg
from .train.checkpoint import to_numpy_tree
from .train.step import sync_model

__all__ = ["params_from_numpy", "params_to_numpy", "train_state_to_numpy",
           "train_state_from_numpy", "tree_path"]


def tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
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
    want = {tree_path(n)[0] for n in params}
    have = set(_leaf_paths(tree))
    if want != have:
        raise ValueError(f"tree leaves differ from the model's: missing {sorted(want - have)}, "
                         f"unexpected {sorted(have - want)}")
    for name, p in params.items():
        path, layer = tree_path(name)
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
    return _tree_from_named({n: p.detach().float() for n, p in model.named_parameters()})


def _tree_from_named(named: Dict[str, torch.Tensor]) -> Dict:
    """{port name: tensor} -> the reference's tree of numpy arrays in the
    tensors' own types. Per-layer leaves are stacked on a leading layer
    axis; per-layer 0-d leaves (SGD's moment stubs) become one 0-d leaf,
    as the reference keeps one stub per stacked leaf."""
    per_layer: Dict[Tuple[str, ...], list] = {}
    tree: Dict = {}
    for name, t in named.items():
        path, layer = tree_path(name)
        a = to_numpy_tree(t)
        if layer is None:
            _put(tree, path, a)
        else:
            per_layer.setdefault(path, []).append((layer, a))
    for path, arrays in per_layer.items():
        arrays = [a for _, a in sorted(arrays, key=lambda la: la[0])]
        _put(tree, path, arrays[0] if arrays[0].ndim == 0 else np.stack(arrays))
    return tree


@torch.no_grad()
def _named_from_tree(tree: Dict, named: Dict[str, torch.Tensor], what: str) -> None:
    """Copy the reference's tree into the tensors of ``named`` in place."""
    for name, t in named.items():
        path, layer = tree_path(name)
        leaf = tree
        for key in path:
            if key not in leaf:
                raise ValueError(f"{what}: the tree has no leaf {'/'.join(path)}")
            leaf = leaf[key]
        a = np.asarray(leaf)
        if layer is not None and a.ndim == t.ndim + 1:
            a = a[layer]
        if a.shape != tuple(t.shape):
            raise ValueError(f"{what} {'/'.join(path)}: tree has {a.shape}, state wants "
                             f"{tuple(t.shape)}")
        a = np.ascontiguousarray(a)
        t.copy_(torch.from_numpy(a if a.flags.writeable else a.copy()))


def train_state_to_numpy(state) -> Dict:
    """{"params": masters tree, "opt_state": {"m": tree, "v": tree, "step":
    int32}} as numpy, the trees a checkpoint holds (``train.checkpoint``).
    Masters and moments keep their types; bf16 moments raise there."""
    opt = state.opt_state
    return {"params": _tree_from_named(state.params),
            "opt_state": {"m": _tree_from_named(opt["m"]), "v": _tree_from_named(opt["v"]),
                          "step": np.asarray(int(opt["step"]), dtype=np.int32)}}


def train_state_from_numpy(state, trees: Dict) -> None:
    """The inverse of ``train_state_to_numpy``, in place: masters, moments
    and step from the reference's trees, then the model's weights from the
    masters."""
    opt = state.opt_state
    _named_from_tree(trees["params"], state.params, "params")
    _named_from_tree(trees["opt_state"]["m"], opt["m"], "opt_state m")
    _named_from_tree(trees["opt_state"]["v"], opt["v"], "opt_state v")
    opt["step"] = torch.tensor(int(np.asarray(trees["opt_state"]["step"])), dtype=torch.int32,
                               device=opt["step"].device)
    sync_model(state)


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
