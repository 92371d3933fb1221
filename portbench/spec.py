"""Finding a cell's files by the names ``BENCHMARK.json`` gives them.

A cell names a configuration and a traffic mix; the harness reads
``configs/<config>.json`` (or the ``file`` the configuration entry names),
``traffic/<traffic>.json`` and ``limits/<workload>.json``, and loads the
driver ``modes/<mode>.py`` that the traffic file's ``mode`` names and each
per-layer metric's reader ``metrics/<metric>.py``. A later cell, mix or
metric is new files plus new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything its run reads."""

    name: str
    config: Dict            # the configuration file's object
    traffic: Dict           # the traffic mix's parameters
    limits: Dict            # number compared -> limit
    end_to_end: List[Dict]  # the end-to-end metric entries this cell reports
    per_layer: List[Dict]   # the per-layer metric entries this cell reports
    chips: int


def load_benchmark(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: Dict, root: Path, workload: str, here: Path = HERE) -> Cell:
    """The cell ``workload`` of ``bench`` with its files read. Raises
    ``KeyError`` for a name ``bench`` does not have."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
                chips=int(w["chips"]))


def load_module(path: Path, name: str):
    """The module in the file ``path`` (whose name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mode_module(traffic: Dict):
    """The driver of a traffic mix: ``modes/<mode>.py``."""
    return importlib.import_module(f"portbench.modes.{traffic['mode']}")


def metric_reader(name: str, here: Path = HERE):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    return load_module(here / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_")).read


def arch_of(config: Dict):
    """The port's ``ArchConfig`` for a configuration file: its ``arch``
    group, which holds the sizes the port takes under the port's field
    names."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**config["arch"])
