"""End-to-end training driver of the port, the counterpart of
``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --scale tiny \\
        --steps 200 --global-batch 32 --seq-len 256 [--device cpu]

``--scale tiny|small`` shrinks the architecture (``scale_arch``, a copy of
the reference's); ``--scale full`` uses the exact config. The loop wires
together the synthetic data pipeline with prefetch, checkpoint/restart in
the reference's format, straggler monitoring and metrics logging. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..configs.base import ArchConfig
from ..convert import train_state_from_numpy, train_state_to_numpy
from ..models.lm import RunCfg
from ..train.checkpoint import CheckpointManager, restore_latest
from ..train.data import DataCfg, PrefetchIterator, SyntheticDataset
from ..train.fault_tolerance import StragglerMonitor
from ..train.optim import OptimizerCfg
from ..train.step import TrainCfg, init_train_state, make_train_step

__all__ = ["scale_arch", "train_loop", "main"]


def scale_arch(arch: ArchConfig, scale: str) -> ArchConfig:
    """Family-preserving reductions for CPU-scale runs."""
    if scale == "full":
        return arch
    dims = {"tiny": (2, 128, 4, 256), "small": (4, 256, 8, 1024)}[scale]
    L, H, nh, V = dims
    nkv = max(1, min(arch.n_kv, nh // 2)) if arch.n_kv else 0
    return dataclasses.replace(
        arch, num_layers=L, d_model=H, n_heads=nh if arch.n_heads else 0,
        n_kv=nkv, head_dim=H // nh if arch.n_heads else 0,
        d_ff=2 * H if arch.d_ff else 0, vocab=min(arch.vocab, V),
        n_experts=min(arch.n_experts, 4) if arch.n_experts else 0,
        top_k=min(arch.top_k, 2) if arch.top_k else 0,
        d_ff_expert=H if arch.n_experts else 0,
        d_inner=2 * H if arch.block in ("ssm", "hymba") else 0,
        ssm_state=min(arch.ssm_state, 16) if arch.ssm_state else 0,
        ssm_headdim=32 if arch.block in ("ssm", "hymba") else 64,
        window=min(arch.window, 64) if arch.window else 0)


def train_loop(arch: ArchConfig, cfg: TrainCfg, data_cfg: DataCfg, steps: int,
               ckpt_dir=None, log_every: int = 10, ckpt_every: int = 50,
               seed: int = 0, log_fn=print, device="cuda"):
    """Train ``steps`` steps on ``SyntheticDataset(arch, data_cfg)``,
    resuming from the latest checkpoint in ``ckpt_dir`` if there is one.
    Returns (train state, losses of the steps run here, grad norms of those
    steps)."""
    dev = resolve_device(device)
    train_step = make_train_step(arch, cfg)
    state = init_train_state(arch, cfg, torch.Generator(device=dev).manual_seed(seed), dev)

    start_step = 0
    manager = None
    if ckpt_dir is not None:
        manager = CheckpointManager(ckpt_dir, every_steps=ckpt_every)
        got, trees, extra = restore_latest(ckpt_dir)
        if got is not None:
            train_state_from_numpy(state, trees)
            del trees
            start_step = extra.get("data_step", got)
            log_fn(f"[restore] resumed from step {got}")

    dataset = SyntheticDataset(arch, data_cfg)
    it = PrefetchIterator(dataset, start_step=start_step)
    monitor = StragglerMonitor()
    losses, gnorms = [], []
    try:
        for step in range(start_step, steps):
            batch = next(it)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.time() - t0
            losses.append(loss)
            gnorms.append(gnorm)
            ev = monitor.record(step, dt)
            if ev:
                log_fn(f"[straggler] step {step}: {ev['ratio']:.1f}x median")
            if step % log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} "
                       f"lr={float(metrics['lr']):.2e} "
                       f"gnorm={gnorm:.3f} {dt:.2f}s")
            if manager is not None:
                manager.maybe_save(step + 1, lambda: train_state_to_numpy(state),
                                   extra={"data_step": step + 1})
        if manager is not None:
            manager.wait()
    finally:
        it.close()
    return state, losses, gnorms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = scale_arch(get_config(args.arch), args.scale)
    cfg = TrainCfg(
        run=RunCfg(remat=False),
        opt=OptimizerCfg(peak_lr=args.lr, warmup_steps=20, decay_steps=args.steps),
        num_microbatches=args.microbatches)
    data_cfg = DataCfg(seq_len=args.seq_len, global_batch=args.global_batch,
                       num_microbatches=args.microbatches, seed=args.seed)
    _, losses, _ = train_loop(arch, cfg, data_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                              seed=args.seed, device=args.device)
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"done: loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
