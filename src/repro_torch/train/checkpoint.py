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
train state into them and back. bf16 has no numpy dtype (the reference
writes bf16 leaves with ``ml_dtypes``, which this port does not use), so a
bf16 leaf raises.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest", "latest_step",
           "CheckpointManager", "to_numpy_tree"]

_SEP = "/"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype without ml_dtypes; checkpoint "
                            "fp32 moments (OptimizerCfg.moment_dtype), ROADMAP queue 1")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
    """state: dict of trees (e.g. {"params": ..., "opt_state": ...})."""
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
            k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()}
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


def restore_checkpoint(ckpt_dir, step: int) -> Tuple[Dict[str, Any], Dict]:
    """(every tree of the checkpoint as nested dicts of numpy arrays,
    extra)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        state = {name: _unflatten({k: data[f"{name}::{k}"] for k in keys})
                 for name, keys in manifest["trees"].items()}
    return state, manifest["extra"]


def restore_latest(ckpt_dir):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None, None
    state, extra = restore_checkpoint(ckpt_dir, step)
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
        self._pending = threading.Thread(
            target=save_checkpoint,
            args=(self.dir, step, host_state),
            kwargs={"extra": extra, "keep_last": self.keep_last})
        self._pending.start()
        if block:
            self.wait()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
