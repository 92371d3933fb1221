"""Per-(arch x shape) launch presets, the counterpart of
``repro.launch.presets``: microbatching, precision policy and sequence
parallelism, the memory-fit levers of a cell.

Defaults: fp32 master weights and fp32 Adam moments, fp32 gradient
accumulation, G microbatches such that each data-parallel row sees one
sequence a microbatch. The heavy arch (nemotron-4-340b) keeps its moments
and its gradient sums in bf16, and the memory- and collective-bound archs
shard the residual stream over "model" on the sequence.

The reference's ``RunCfg`` fields ``q_chunk``, ``ssd_chunk`` and
``scan_layers`` are dropped, as the port's ``RunCfg`` has none of them
(``models.lm.RunCfg``): the flash kernel tiles the queries itself, the SSD
kernel blocks by its own 64-token chunks, and the layers are a loop.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.lm import RunCfg
from ..train.optim import OptimizerCfg
from ..train.step import TrainCfg

__all__ = ["train_cfg_for", "run_cfg_for", "microbatches_for", "BF16_STATE", "SEQ_SHARD"]

# archs whose per-device footprint needs the bf16-state policy
BF16_STATE = frozenset({"nemotron-4-340b"})
# sequence-parallel residuals for the memory- and collective-bound archs
# (the reference keeps them selective: its own note, presets.py:26-31)
SEQ_SHARD = frozenset({"nemotron-4-340b", "llava-next-34b", "dbrx-132b"})


def microbatches_for(arch: ArchConfig, shape: ShapeConfig, dp_total: int) -> int:
    """G: one sequence a data-parallel row a microbatch (1 for serving)."""
    if shape.kind != "train":
        return 1
    return max(1, shape.global_batch // dp_total)


def run_cfg_for(arch: ArchConfig, shape: ShapeConfig) -> RunCfg:
    """bf16 compute; fp32 masters and remat for training, bf16 weights for
    serving; ``seq_shard`` for ``SEQ_SHARD``."""
    train = shape.kind == "train"
    return RunCfg(compute_dtype=torch.bfloat16,
                  param_dtype=torch.float32 if train else torch.bfloat16,
                  remat=train,
                  seq_shard=arch.name in SEQ_SHARD)


def train_cfg_for(arch: ArchConfig, shape: ShapeConfig, dp_total: int) -> TrainCfg:
    """``run_cfg_for``'s run config, Adam with fp32 moments (bf16 for
    ``BF16_STATE``), ``microbatches_for``'s G, fp32 gradient sums (bf16
    for ``BF16_STATE``)."""
    bf16_state = arch.name in BF16_STATE
    return TrainCfg(run=run_cfg_for(arch, shape),
                    opt=OptimizerCfg(moment_dtype=torch.bfloat16 if bf16_state else torch.float32),
                    num_microbatches=microbatches_for(arch, shape, dp_total),
                    grad_accum_dtype=torch.bfloat16 if bf16_state else torch.float32)
