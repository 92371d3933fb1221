"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell walked
once on tensors without storage, the counterpart of
``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all       # every cell, one subprocess each

A cell runs as rank 0 of a "fake" process group of 256 ("single", the
16x16 pod) or 512 ("multi", 2x16x16) ranks, on the production mesh
(``launch.mesh.make_production_mesh``) over the meta device: every tensor
is a meta tensor, every collective a no-op of the fake group, and each
kernel op (``kernels.build.define_op``) runs its fake implementation: the
CUDA path's checks and allocations, no launch. So a cell runs the real
entry point once, as the card would, and needs no card:

* train: ``init_train_state`` + ``make_train_step`` at ``train_cfg_for``'s G;
* prefill: ``init_params`` + ``make_prefill_step``;
* decode: ``init_params`` + ``make_serve_step`` at the last cache slot.

One dispatch mode watches the step (``measure``, ``StepMeter``): the
bytes of live storages, for the per-device peak (each storage rounded up
to the CUDA caching allocator's 512 bytes); the bytes and calls of each
collective kind (``comm_analysis.CollectiveCounter``); the flops that
``FlopCounterMode`` counts (the matrix products, and the kernel ops
through the formulas they register; elementwise work counts nothing).
The record (``artifacts/dryrun_torch/<cell>.json``) keeps the
reference's keys where they mean the same, and adds ``memory`` (the peak
and the argument bytes: master weights, optimizer state, compute-dtype
weights, batch or cache), ``flops``, ``collectives``, ``target`` (the card
judged against: ``build.TARGET_*``, which ``chip_smoke.py`` holds to the
card) and ``fits`` (the peak within the card's memory; the CUDA context
and the allocator's free blocks are not in the peak).

What the reference has and this does not: its ``probes`` and
``extrapolated`` keys (XLA's ``cost_analysis`` counts a ``while`` body once,
so it extrapolates from unrolled probe compiles; the eager step here runs
every layer and microbatch, so its counts are whole); XLA's "bytes
accessed" (an eager step has no compiled program whose memory traffic
could be read); ``palm_trace_record`` and ``--palm-trace`` (a trace of
the PALM simulator beside the step's; the port has the simulator,
``repro_torch.core`` and ``repro_torch.api``, and this flag is queued in
ROADMAP.md §1, "The rest of the simulator", item 3).

Why meta tensors and not fake ``cuda`` ones: in a PyTorch built without
CUDA, autograd's engine asks the CUDA device guard of a fake ``cuda``
tensor for its stream and the process aborts; the meta device has a
guard. The kernel ops' fake implementations serve both.

Initialisation draws each full weight on every rank and keeps its shard
(``init_params(mesh=)``), which costs nothing here; the peak is taken over
the step, with the state already built.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import build
from ..models.lm import LM, RunCfg, init_params
from ..serving.serve import make_prefill_step, make_serve_step
from ..train.step import TrainCfg, init_train_state, make_train_step
from .comm_analysis import CollectiveCounter, collective_kind
from .input_specs import decode_input_specs, prefill_input_specs, train_input_specs
from .mesh import make_production_mesh
from .presets import run_cfg_for, train_cfg_for

__all__ = ["StepMeter", "measure", "tensor_bytes", "train_argument_bytes", "dry_train",
           "dry_prefill", "dry_decode", "run_cell",
           "model_flops", "all_cells", "fake_world", "target", "main", "ALLOC_ROUND"]

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
ALLOC_ROUND = 512       # the CUDA caching allocator rounds every block up to this


def target() -> Dict[str, Any]:
    """The card a cell is judged against (``build.TARGET_*``, which
    ``chip_smoke.py`` holds to the card)."""
    return {"name": build.TARGET_NAME, "total_memory": build.TARGET_MEMORY,
            "sms": build.TARGET_SMS}


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


class StepMeter(TorchDispatchMode):
    """One dispatch mode that meters a program on the meta device:

    * ``live`` / ``peak``: bytes of the live storages that ops under it
      create, each rounded up to ``ALLOC_ROUND``, ``peak`` since the last
      ``reset_peak``. A storage counts from the op that creates it until its
      last tensor dies. A kernel op's fake implementation runs under the
      mode, so its scratch counts while the op runs, as on the card.
    * ``flops``: what ``FlopCounterMode`` counts (its formula registry, and
      its decomposition of an op that has none), from ``count_from`` on.
    * ``comm``: a ``comm_analysis.CollectiveCounter``, from ``count_from`` on.

    One mode and not three stacked: each stacked mode is another trip
    through Python for every op."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.flops = 0
        self.comm = CollectiveCounter()
        self.counting = False
        self._sizes: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self._ops: Dict[Any, tuple] = {}

    def reset_peak(self) -> None:
        self.peak = self.live

    def count_from(self) -> None:
        """Start counting flops and collectives (the step, not its set-up)."""
        self.counting = True

    def _track(self, t) -> None:
        if type(t) is not torch.Tensor:
            t = getattr(t, "_local_tensor", t)      # a DTensor's shard
            if not isinstance(t, torch.Tensor):
                return
        if not t.is_meta:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = _rounded(st.nbytes())
        self._sizes[key] = n
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)
        del self._refs[key]

    def _op(self, func):
        """(fake implementation, whether FlopCounterMode would decompose it,
        flop formula, whether a collective) of an op, looked up once."""
        decomposes = (func._overloadpacket not in flop_registry and
                      torch._C._dispatch_has_kernel_for_dispatch_key(
                          func.name(), "CompositeImplicitAutograd"))
        info = self._ops[func] = (build.fake_impl(func), decomposes,
                                  flop_registry.get(func._overloadpacket),
                                  collective_kind(func) is not None)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._ops.get(func) or self._op(func)
        fake, decomposes, formula, collective = info
        if fake is not None:
            with self:
                out = fake(*args, **kwargs)
        else:
            if decomposes:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
        if type(out) is torch.Tensor:
            self._track(out)
        else:
            for t in tree_leaves(out):
                self._track(t)
        if self.counting:
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if collective:
                self.comm.count(func, args, out)
        return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (numel x element size, a DTensor's
    local shard), unrounded."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            total += t.numel() * t.element_size()
    return total


def measure(build_args: Callable[[], Any], step: Callable[[Any], Any]) -> Dict[str, Any]:
    """Run ``step(build_args())`` on meta tensors under a ``StepMeter``:
    the peak live bytes over the step (the arguments included), the bytes
    live when it starts, its collectives and its flops."""
    meter = StepMeter()
    with meter:
        args = build_args()
        gc.collect()
        meter.reset_peak()
        start = meter.live
        meter.count_from()
        out = step(args)
        del out
    return {"args": args, "peak_bytes": meter.peak, "live_bytes_at_start": start,
            "flops": meter.flops, "collectives": meter.comm.record()}


def _record(m: Dict[str, Any], argument_bytes: Dict[str, int]) -> Dict[str, Any]:
    tgt = target()
    return {"memory": {"peak_bytes": m["peak_bytes"],
                       "live_bytes_at_start": m["live_bytes_at_start"],
                       "argument_bytes": argument_bytes},
            "flops": m["flops"], "collectives": m["collectives"], "target": tgt,
            "fits": m["peak_bytes"] <= tgt["total_memory"]}


def train_argument_bytes(state, batch) -> Dict[str, int]:
    """A train step's argument bytes on this device: the master weights,
    the optimizer state, the compute-dtype weights and the batch."""
    return {"params": tensor_bytes(state.params), "opt_state": tensor_bytes(state.opt_state),
            "model": tensor_bytes(list(state.model.parameters())), "batch": tensor_bytes(batch)}


def dry_train(arch: ArchConfig, cfg: TrainCfg, batch: Callable[[], Dict],
              mesh=None) -> Dict[str, Any]:
    """One ``make_train_step`` step from ``init_train_state`` on the meta
    device (on ``mesh`` if given), on the batch ``batch()`` makes."""
    def build_args():
        state = init_train_state(arch, cfg, torch.Generator().manual_seed(0), "meta", mesh=mesh)
        return state, batch()

    m = measure(build_args, lambda a: make_train_step(arch, cfg, mesh)(*a))
    return _record(m, train_argument_bytes(*m["args"]))


def _serving_model(arch: ArchConfig, run: RunCfg, mesh) -> LM:
    return init_params(arch, torch.Generator().manual_seed(0), dataclasses.replace(run, mesh=mesh),
                       device="meta")


def dry_prefill(arch: ArchConfig, run: RunCfg, batch: Callable[[], Dict],
                mesh=None) -> Dict[str, Any]:
    """One ``make_prefill_step`` call on ``init_params``' model (meta)."""
    m = measure(lambda: (_serving_model(arch, run, mesh), batch()),
                lambda a: make_prefill_step(a[0])(a[1]))
    model, b = m["args"]
    args = {"model": tensor_bytes(list(model.parameters())), "batch": tensor_bytes(b)}
    return _record(m, args)


def dry_decode(arch: ArchConfig, run: RunCfg, inputs: Callable[[LM], Any],
               mesh=None) -> Dict[str, Any]:
    """One ``make_serve_step`` call on ``init_params``' model (meta), on
    ``inputs(model) = (cache, tokens, pos)``."""
    def build_args():
        model = _serving_model(arch, run, mesh)
        return model, *inputs(model)

    m = measure(build_args, lambda a: make_serve_step(a[0])(*a[1:]))
    model, cache, tokens, _ = m["args"]
    args = {"model": tensor_bytes(list(model.parameters())), "cache": tensor_bytes(cache),
            "batch": tensor_bytes(tokens)}
    return _record(m, args)


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    N = arch.active_param_count()
    if shape.kind == "train":
        return 6.0 * N * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * N * shape.global_batch * shape.seq_len
    return 2.0 * N * shape.global_batch  # decode: one token per sequence


def fake_world(world_size: int) -> None:
    """This process as rank 0 of a "fake" process group of ``world_size``
    ranks (collectives return at once, moving nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def run_cell(arch_name: str, shape_name: str, mesh_kind: str) -> Dict[str, Any]:
    """The record of one cell (``fake_world`` first, once a process)."""
    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(arch, shape)
    multi = mesh_kind == "multi"
    record = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
              "applicable": ok, "skip_reason": reason, "chips": 512 if multi else 256,
              "params": arch.param_count(), "active_params": arch.active_param_count(),
              "model_flops": model_flops(arch, shape)}
    if not ok:
        return record
    mesh = make_production_mesh(multi_pod=multi, device_type="meta")
    run = run_cfg_for(arch, shape)
    if shape.kind == "train":
        cfg = train_cfg_for(arch, shape, 32 if multi else 16)
        G = cfg.num_microbatches
        record.update(dry_train(arch, cfg, lambda: train_input_specs(arch, shape, G), mesh))
        record["config"] = {"num_microbatches": G, "microbatch_size": shape.global_batch // G,
                            "seq_shard": cfg.run.seq_shard, "remat": cfg.run.remat,
                            "moment_dtype": str(cfg.opt.moment_dtype).removeprefix("torch."),
                            "grad_accum_dtype":
                                str(cfg.grad_accum_dtype).removeprefix("torch.")}
    elif shape.kind == "prefill":
        record.update(dry_prefill(arch, run, lambda: prefill_input_specs(arch, shape), mesh))
        record["config"] = {"seq_shard": run.seq_shard}
    else:
        record.update(dry_decode(arch, run, lambda model: decode_input_specs(model, shape), mesh))
        record["config"] = {"cache_len": shape.seq_len, "pos": shape.seq_len - 1}
    record["ok"] = True
    return record


def all_cells():
    for arch_name in sorted(ARCHS):
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for mesh_kind in ("single", "multi"):
                yield arch_name, shape_name, mesh_kind


def _sweep(out_dir: Path, force: bool) -> int:
    """Every cell of ``all_cells`` in a subprocess of its own (a fresh
    process group each; a failure stops nothing)."""
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    failures = []
    for a, s, m in all_cells():
        path = out_dir / f"{a}__{s}__{m}.json"
        if path.exists() and not force:
            print(f"[skip cached] {path.name}")
            continue
        print(f"[run] {a} x {s} x {m}", flush=True)
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                            "--shape", s, "--mesh", m, "--out", str(out_dir)], env=env)
        if r.returncode != 0:
            failures.append((a, s, m))
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", type=str, choices=sorted(ARCHS))
    ap.add_argument("--shape", type=str, choices=list(SHAPES))
    ap.add_argument("--mesh", type=str, default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="with --all: rerun cached cells")
    ap.add_argument("--out", type=str, default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        return _sweep(out_dir, args.force)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")
    path = out_dir / f"{args.arch}__{args.shape}__{args.mesh}.json"
    t0 = time.time()
    try:
        fake_world(512 if args.mesh == "multi" else 256)
        record = run_cell(args.arch, args.shape, args.mesh)
    except Exception:
        record = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh, "ok": False,
                  "error": traceback.format_exc(), "wall_s": round(time.time() - t0, 2)}
        path.write_text(json.dumps(record, indent=1))
        print(record["error"], file=sys.stderr)
        return 1
    record["wall_s"] = round(time.time() - t0, 2)
    path.write_text(json.dumps(record, indent=1))
    if record.get("ok"):
        status = (f"OK: peak {record['memory']['peak_bytes'] / 2**30:.2f} GiB "
                  f"({'fits' if record['fits'] else 'does not fit'} "
                  f"{record['target']['name']}), {record['flops']:.4g} flops, "
                  f"{record['collectives']['calls']['total']} collectives")
    else:
        status = f"SKIP ({record.get('skip_reason')})"
    print(f"{args.arch} x {args.shape} x {args.mesh}: {status} [{record['wall_s']}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
