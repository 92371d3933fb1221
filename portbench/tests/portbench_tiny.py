"""Cells of ``BENCHMARK.json`` cut to tiny widths, for CPU tests."""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "mamba2-train-2k": ({"num_layers": 2, "d_model": 64, "vocab": 256, "d_inner": 128,
                         "ssm_state": 16, "ssm_headdim": 32},
                        {"seq_len": 64, "microbatches": 2}),
    "yi6b-prefill-docqa": ({"num_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2, "d_ff": 128,
                            "vocab": 256},
                           {"lengths": {"dist": "fixed", "length": 48, "count": 6},
                            "checked_requests": 4}),
}


def cell(name: str, compute: str = "bfloat16") -> spec.Cell:
    """The cell ``name`` at tiny widths, its program computing in ``compute``."""
    c = spec.find_cell(spec.load_benchmark(ROOT), ROOT, name)
    arch, traffic = TINY[name]
    config = copy.deepcopy(c.config)
    config["arch"].update(arch)
    config["dtype"]["compute"] = compute
    return dataclasses.replace(c, config=config, traffic={**copy.deepcopy(c.traffic), **traffic})
