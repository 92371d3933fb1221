"""Step-addressed checkpoints in the reference's on-disk format
(``repro.train.checkpoint``), so a checkpoint crosses between the two
packages in both directions.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (per-tree key,
shape and dtype; the step; ``extra``, e.g. the data-pipeline cursor).
Arrays are keyed ``<tree>::<a/b/c>``, the tree's dict keys joined by "/"
(the reference's ``tree_flatten_with_path`` names). Writes go to
``step_<N>.tmp`` and are renamed into place, so a crash mid-save never
corrupts the latest checkpoint; ``keep_last`` prunes old steps.

Trees here are nested dicts of numpy arrays (or anything ``np.asarray``
takes, CPU or CUDA tensors included); ``repro_torch.convert`` turns a
train state into them and back. bf16 has no numpy dtype: the reference
writes a bf16 leaf through ``ml_dtypes``, which ``np.savez`` stores as raw
2-byte values (``|V2``) under the manifest dtype ``"bfloat16"``. The port
writes the same bytes without ``ml_dtypes`` (the tensor's bits viewed as
``|V2``) and, reading the dtype from the manifest, restores such a leaf as
a CPU bf16 tensor.

A sharded state (DTensor leaves) writes the same files: every rank gathers
each leaf (``full_tensor``) and rank 0 writes. ``restore_checkpoint`` with
``placements`` hands its leaves back as DTensors on a mesh, any mesh.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.comm import is_dtensor

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest", "latest_step",
           "CheckpointManager", "to_numpy_tree", "leaf_tensor"]

_SEP = "/"
BF16 = "bfloat16"           # manifest dtype of a bf16 leaf, stored as raw |V2
_RAW2 = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if is_dtensor(leaf):             # a collective: every rank of its mesh calls it
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).cpu().numpy().view(_RAW2)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(a: np.ndarray) -> str:
    """The manifest dtype: ``"bfloat16"`` for raw 2-byte leaves (and for
    ml_dtypes' bfloat16, whose name it already is)."""
    return BF16 if a.dtype == _RAW2 else str(a.dtype)


def leaf_tensor(leaf) -> torch.Tensor:
    """A checkpoint leaf as a CPU tensor: tensors as they are; raw |V2
    arrays and ml_dtypes bfloat16 arrays as bf16 (their bits); any other
    array through ``torch.from_numpy``."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    if a.dtype == _RAW2 or a.dtype.name == BF16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy_tree(tree):
    """The same nested dict with every leaf on the host as numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return _host(tree)


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Leaves by "/"-joined key path, in sorted key order (jax's)."""
    if not isinstance(tree, dict):
        return {_SEP.join(prefix): tree}
    flat = {}
    for key in sorted(tree):
        flat.update(_flatten(tree[key], prefix + (str(key),)))
    return flat


def save_checkpoint(ckpt_dir, step: int, state: Dict[str, Any],
                    extra: Optional[Dict] = None, keep_last: int = 3) -> Path:
    """state: dict of trees (e.g. {"params": ..., "opt_state": ...}). With a
    process group (a sharded state), every rank calls it: DTensor leaves
    are gathered, rank 0 writes, and the others wait for it at a barrier."""
    if dist.is_initialized():
        host = {name: to_numpy_tree(tree) for name, tree in state.items()}
        final = Path(ckpt_dir) / f"step_{step:08d}"
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, host, extra, keep_last)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, state, extra, keep_last)


def _write(ckpt_dir, step: int, state: Dict[str, Any], extra: Optional[Dict],
           keep_last: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {}
    manifest = {"step": step, "trees": {}, "extra": extra or {}}
    for name, tree in state.items():
        flat = {k: _host(v) for k, v in _flatten(tree).items()}
        manifest["trees"][name] = {
            k: {"shape": list(v.shape), "dtype": _dtype_name(v)} for k, v in flat.items()}
        for k, v in flat.items():
            arrays[f"{name}::{k}"] = v
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    steps = sorted(p for p in ckpt_dir.glob("step_????????") if p.is_dir())
    for old in steps[:-keep_last]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_????????"))
    return steps[-1] if steps else None


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        *path, last = key.split(_SEP)
        for part in path:
            node = node.setdefault(part, {})
        node[last] = val
    return tree


def restore_checkpoint(ckpt_dir, step: int, placements: Optional[Dict[str, Dict]] = None
                       ) -> Tuple[Dict[str, Any], Dict]:
    """(every tree of the checkpoint as nested dicts of numpy arrays, and
    of CPU bf16 tensors where the manifest says ``"bfloat16"``, extra).
    ``placements`` (the counterpart of the reference's ``shardings``) maps
    a tree name to {leaf path in the tree: ``MeshPlacements``}
    (``ShardingPlanner.checkpoint``): those leaves come back as DTensors
    on that mesh, each rank holding its shards."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    placements = placements or {}

    def leaf(a, meta, placed):
        if meta["dtype"] == BF16 or placed is not None:
            a = leaf_tensor(a.view(_RAW2) if meta["dtype"] == BF16 else a)
        return a if placed is None else placed.distribute(a)

    with np.load(path / "arrays.npz") as data:
        state = {name: _unflatten({k: leaf(data[f"{name}::{k}"], meta,
                                           placements.get(name, {}).get(k))
                                   for k, meta in keys.items()})
                 for name, keys in manifest["trees"].items()}
    return state, manifest["extra"]


def restore_latest(ckpt_dir, placements=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None, None
    state, extra = restore_checkpoint(ckpt_dir, step, placements)
    return step, state, extra


class CheckpointManager:
    """Periodic async checkpointing: the save runs on a background thread
    so the train loop is not blocked. The state is copied to the host
    before the thread starts: the train step updates it in place."""

    def __init__(self, ckpt_dir, every_steps: int = 100, keep_last: int = 3):
        self.dir = Path(ckpt_dir)
        self.every = every_steps
        self.keep_last = keep_last
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state: Dict[str, Any], extra=None,
                   block: bool = False):
        """``state``: a dict of trees, or a callable returning one (called
        only when this step saves)."""
        if step % self.every != 0:
            return False
        self.wait()
        host_state = to_numpy_tree(state() if callable(state) else state)
        if dist.is_initialized():           # every rank takes part: save in this thread
            save_checkpoint(self.dir, step, host_state, extra, self.keep_last)
            return True
        self._pending = threading.Thread(
            target=_write,
            args=(self.dir, step, host_state, extra, self.keep_last))
        self._pending.start()
        if block:
            self.wait()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
