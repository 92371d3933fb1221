"""Sharding rules: FSDP(data) x TP(model) x optional DP(pod), per leaf;
the counterpart of ``repro.parallel.sharding``, whose module imports jax,
so the port keeps its own copy of the rules.

The scheme, as the reference's:

* every weight matrix is sharded on one dim by ``model`` (Megatron TP:
  head/ffn dims) and on another by ``data`` (ZeRO-3/FSDP: the model
  gathers each weight when its layer runs, and the gradients are
  reduce-scattered back onto these placements),
* optimizer state mirrors the parameter shardings (ZeRO-1/2),
* activations: batch over ``(pod, data)``; with sequence parallelism the
  residual stream is additionally sharded over ``model`` on the sequence
  dim between blocks (``RunCfg.seq_shard``),
* KV caches: batch over ``data``, sequence over ``model``; SSM states:
  head dim over ``model``.

Every rule is a fallback chain evaluated against the actual leaf shape and
the mesh's axis sizes: a dim is sharded only where it divides evenly.

A spec is a tuple with one entry a tensor dim, as ``PartitionSpec`` reads:
``None`` (replicated), an axis name, or a tuple of axis names (one dim
split over several axes, major to minor). The rules take axis sizes, a
mapping such as ``{"data": 16, "model": 16}``, not a live mesh, so the
specs of a 256-chip mesh can be computed anywhere.

The reference stacks per-layer leaves on a leading layer axis ([L, H,
nh*hd]) and every stacked rule puts ``None`` on it; the port keeps one
``Block`` a layer (``blocks.<i>.attn.wq`` is [H, nh*hd]), so a per-layer
leaf's spec is the reference's without that first entry.
``ShardingPlanner`` turns specs into DTensor placements on a
``DeviceMesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig

__all__ = ["param_pspecs", "batch_pspec", "cache_pspecs", "ShardingPlanner", "fit_spec",
           "fit_first", "axis_sizes", "leaf_path", "placements_of", "local_slices",
           "MeshPlacements", "mesh_device", "local_rows"]

FSDP = "data"
TP = "model"

Spec = Tuple[Any, ...]


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(axes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= axes[a]
        return out
    return axes[axis]


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: one axis in a tuple is
    that axis."""
    if isinstance(axis, (tuple, list)):
        return axis[0] if len(axis) == 1 else tuple(axis)
    return axis


def fit_spec(spec: Spec, shape: Tuple[int, ...], axes: Mapping[str, int]) -> Optional[Spec]:
    """Return the spec if every sharded dim divides evenly, else None."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for d, axis in zip(shape, dims):
        if axis is not None and d % _axis_size(axes, axis) != 0:
            return None
    return tuple(_entry(a) for a in dims)


def fit_first(candidates, shape: Tuple[int, ...], axes: Mapping[str, int]) -> Spec:
    """First candidate that divides; last resort drops offending axes."""
    for cand in candidates:
        ok = fit_spec(cand, shape, axes)
        if ok is not None:
            return ok
    base = list(candidates[0]) + [None] * (len(shape) - len(candidates[0]))
    return tuple(_entry(a) if a is not None and d % _axis_size(axes, a) == 0 else None
                 for d, a in zip(shape, base))


def _leaf_candidates(path: Tuple[str, ...], ndim: int):
    """Ordered sharding rules by (parent, name), for the reference's
    (layer-stacked) leaf of ``ndim`` dims."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""

    if name == "embed":      # [V, H]
        return [(TP, FSDP), (None, FSDP)]
    if name == "lm_head":    # [H, V]
        return [(FSDP, TP), (FSDP, None)]
    if name == "final_norm":
        return [(None,)]
    if name in ("norm1", "norm2"):
        return [(None, None)]

    if parent == "attn":
        if name in ("wq", "wk", "wv"):   # [L, H, heads*hd]
            return [(None, FSDP, TP), (None, FSDP, None)]
        if name == "wo":                 # [L, heads*hd, H]
            return [(None, TP, FSDP), (None, None, FSDP)]
    if parent == "mlp":
        if name in ("wi", "wg"):         # [L, H, F]
            return [(None, FSDP, TP), (None, FSDP, None)]
        if name == "wo":                 # [L, F, H]
            return [(None, TP, FSDP), (None, None, FSDP)]
    if parent == "moe":
        if name == "router":             # [L, H, E]
            return [(None, FSDP, None)]
        if name in ("wi", "wg"):         # [L, E, H, F]: EP, else intra-expert TP
            return [(None, TP, FSDP, None), (None, None, FSDP, TP),
                    (None, None, FSDP, None)]
        if name == "wo":                 # [L, E, F, H]
            return [(None, TP, None, FSDP), (None, None, TP, FSDP),
                    (None, None, None, FSDP)]
    if parent == "ssm":
        if name == "in_proj":            # [L, H, d_in_proj]
            return [(None, FSDP, TP), (None, FSDP, None)]
        if name == "out_proj":           # [L, d_inner, H]
            return [(None, TP, FSDP), (None, None, FSDP)]
        if name == "conv_w":             # [L, K, conv_dim]
            return [(None, None, TP), (None, None, None)]
        if name in ("conv_b", "ssm_norm"):
            return [(None, TP), (None, None)]
        if name in ("A_log", "D", "dt_bias"):
            return [(None, None)]
    return [(None,) * ndim]


def leaf_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """A port parameter name -> (the reference's tree path, stacked):
    ``blocks.3.attn.wq`` -> (("layers", "attn", "wq"), True)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("layers", *parts[2:]), True
    return tuple(parts), False


def _named_shapes(model_or_shapes) -> Dict[str, Tuple[int, ...]]:
    if isinstance(model_or_shapes, nn.Module):
        return {n: tuple(p.shape) for n, p in model_or_shapes.named_parameters()}
    return {n: tuple(s.shape) if hasattr(s, "shape") else tuple(s)
            for n, s in model_or_shapes.items()}


def param_pspecs(model_or_shapes, axes: Mapping[str, int]) -> Dict[str, Spec]:
    """{port parameter name: spec} for a model, or for {name: shape or
    tensor}; every spec is divisibility-checked against ``axes``. A
    per-layer leaf takes the rules of its stacked counterpart with the
    layer entry (always ``None``) dropped."""
    out = {}
    for name, shape in _named_shapes(model_or_shapes).items():
        path, stacked = leaf_path(name)
        cands = _leaf_candidates(path, len(shape) + stacked)
        if stacked:
            cands = [c[1:] for c in cands]
        out[name] = fit_first(cands, shape, axes)
    return out


def batch_pspec(axes: Mapping[str, int], leading_scan_dim: bool = False) -> Spec:
    """Batch sharding: batch dim over (pod?, data)."""
    batch = ("pod", "data") if "pod" in axes else "data"
    if leading_scan_dim:                      # [n_microbatch, B, S]
        return (None, batch)
    return (batch,)


def cache_pspecs(arch: ArchConfig, cache, axes: Mapping[str, int]) -> Dict[str, Spec]:
    """Decode-cache shardings: KV [L,B,S,nkv,hd] -> batch over data,
    sequence over model (context-parallel decode); SSM state
    [L,B,nh,hp,N] -> heads (or head-dim) over model. Batch-1 decode
    drops the data axis via the fallback chains. ``cache`` maps names to
    tensors or shapes."""
    cands = {
        "k": [(None, FSDP, TP, None, None), (None, None, TP, None, None),
              (None, None, None, None, None)],
        "v": [(None, FSDP, TP, None, None), (None, None, TP, None, None),
              (None, None, None, None, None)],
        "conv": [(None, FSDP, None, TP), (None, None, None, TP),
                 (None, None, None, None)],
        "ssm": [(None, FSDP, TP, None, None), (None, FSDP, None, TP, None),
                (None, None, TP, None, None), (None, None, None, TP, None),
                (None, None, None, None, None)],
    }
    shapes = _named_shapes(cache)
    return {k: fit_first(cands[k], shapes[k], axes) for k in shapes}


def placements_of(spec: Spec, mesh_dim_names: Sequence[str]) -> tuple:
    """DTensor placements of ``spec`` on a mesh with these axis names: a
    dim sharded over one axis is ``Shard(dim)`` on that mesh dim; a dim
    over several axes is ``Shard(dim)`` on each, which DTensor splits in
    mesh-dim order, so the axes must come major to minor in the mesh's
    order (as JAX reads them); every other mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [mesh_dim_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {names} are not in the mesh's order "
                             f"{tuple(mesh_dim_names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_slices(shape: Sequence[int], mesh, placements) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` at ``placements`` (even
    shards only, as the rules give), one slice a dim; empty slices on a
    rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return tuple(slice(0, 0) for _ in shape)
    out = []
    for dim, n in enumerate(shape):
        index, parts = 0, 1
        for m, pl in enumerate(placements):
            if pl.is_shard(dim):
                index = index * mesh.size(m) + coord[m]
                parts *= mesh.size(m)
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split into {parts} parts")
        size = n // parts
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def local_rows(t, mesh, batch_axes, leading_scan_dim: bool = False):
    """This rank's rows of a whole batch leaf ``t`` ([B, ...], or [G, B, ...]
    with ``leading_scan_dim``): the batch dim over ``batch_axes`` where it
    divides them (``fit_first``), else all of it."""
    axes, entry = axis_sizes(mesh), _entry(tuple(batch_axes))
    spec = fit_first([(None, entry) if leading_scan_dim else (entry,)], tuple(t.shape), axes)
    return t[local_slices(t.shape, mesh, placements_of(spec, mesh.mesh_dim_names))]


@dataclass(frozen=True)
class MeshPlacements:
    """Where one tensor lives: a mesh and its placements on it (the
    counterpart of ``NamedSharding``)."""

    mesh: Any
    placements: tuple

    def wrap(self, local: torch.Tensor, shape) -> torch.Tensor:
        """The DTensor of global ``shape`` whose shard on this rank is ``local``."""
        from torch.distributed.tensor import DTensor
        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False,
                                  shape=shape, stride=stride)

    def empty(self, shape, dtype, device) -> torch.Tensor:
        """An uninitialised DTensor of global ``shape``: this rank's shard only."""
        idx = local_slices(shape, self.mesh, self.placements)
        local = torch.empty([len(range(*s.indices(n))) for s, n in zip(idx, shape)],
                            dtype=dtype, device=device)
        return self.wrap(local, shape)

    def distribute(self, t: torch.Tensor) -> torch.Tensor:
        """The DTensor of a whole tensor ``t`` that every rank holds: this
        rank's block on the mesh's device, copied out (no communication;
        ``t`` itself where the block is all of it and ``t`` is there)."""
        block = t[local_slices(t.shape, self.mesh, self.placements)].to(mesh_device(self.mesh))
        block = block.clone() if block.numel() != t.numel() else block.contiguous()
        return self.wrap(block, t.shape)


@dataclass
class ShardingPlanner:
    """Bundles a ``DeviceMesh`` and an arch: per-tree DTensor placements
    for one launch configuration."""

    mesh: Any
    arch: ArchConfig

    @property
    def axes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    def placements(self, spec: Spec) -> tuple:
        return placements_of(spec, self.mesh.mesh_dim_names)

    def params(self, model_or_shapes) -> Dict[str, tuple]:
        """{parameter name: placements}."""
        return {n: self.placements(s)
                for n, s in param_pspecs(model_or_shapes, self.axes).items()}

    def opt_state(self, model_or_shapes) -> Dict[str, Any]:
        """Optimizer state placements: moments mirror the parameters' (ZeRO:
        sharded states), the step is replicated. Matches
        ``repro_torch.train.optim``'s {"m": {...}, "v": {...}, "step"}."""
        p = self.params(model_or_shapes)
        return {"m": p, "v": p, "step": self.placements(())}

    def batch(self, leading_scan_dim: bool = False, example_shape=None) -> tuple:
        spec = batch_pspec(self.axes, leading_scan_dim)
        if example_shape is not None:
            spec = fit_first([spec], tuple(example_shape), self.axes)
        return self.placements(spec)

    def cache(self, cache) -> Dict[str, tuple]:
        return {k: self.placements(s) for k, s in cache_pspecs(self.arch, cache, self.axes).items()}

    def checkpoint(self, model_or_shapes) -> Dict[str, Dict[str, MeshPlacements]]:
        """Where each leaf of a train state's checkpoint goes, by tree name and
        the leaf's "/"-joined path in that tree (the reference's
        layer-stacked layout: {"params": {"layers/attn/wq": ...}, "opt_state":
        {"m/layers/attn/wq": ...}}), for ``train.checkpoint.restore_checkpoint``.
        A stacked leaf takes its layer's placements with the sharded dims
        moved past the layer axis. The step, a scalar, stays on the host."""
        from torch.distributed.tensor import Shard
        flat = {}
        for name, pl in self.params(model_or_shapes).items():
            path, stacked = leaf_path(name)
            if stacked:
                pl = tuple(Shard(p.dim + 1) if p.is_shard() else p for p in pl)
            flat["/".join(path)] = MeshPlacements(self.mesh, pl)
        opt = {f"{k}/{path}": v for k in ("m", "v") for path, v in flat.items()}
        return {"params": flat, "opt_state": opt}
