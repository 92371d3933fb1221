#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (start, the port's kernels loaded or
built under ``build/repro_torch/``, weights drawn on the card, warm-up) is
``setup_s``; then either the measured window of ``--seconds`` (``--trace
0``: the cell's end-to-end metrics) or a traced window of the traffic's
fixed work under ``torch.profiler`` (``--trace 1``: its per-layer metrics,
``busy_s``, ``window_s`` and a ``breakdown``). The peak memory is read
when the window closes; the port's state is then freed and the plain
reference checks what the window's path produced. The last line of
standard output is the result; the numbers compared, each beside its
limit, end standard error and the result's line.

Exits 2 without the cards the cell asks for, and 3 if JAX, Flax or the
JAX package ``repro`` is loaded when the window has closed; neither
prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules():
    """Loaded modules whose top-level name is one of ``FOREIGN``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FOREIGN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def judge(numbers, limits, failed):
    """(correct, checks): every number at or under its limit, and no
    failed step or request."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import spec
    cell = spec.find_cell(spec.load_benchmark(ROOT), ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    driver = spec.mode_module(cell.traffic).Driver(cell, args.seed, device)
    driver.setup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics, extra = {}, {}
    if args.trace:
        tr = driver.traced()
        attempted, failed = tr.work.get("steps", tr.work.get("requests")), 0
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown()
    else:
        res = driver.window(args.seconds)
        attempted, failed = res["attempted"], res["failed"]
        res["metrics"].update(setup_s=setup_s)
        for name in (m["name"] for m in cell.end_to_end):
            if name == "peak_mem_gib":
                continue
            metrics[name] = {"value": res["metrics"][name], "unit": units[name]}
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    if "peak_mem_gib" in units and not args.trace:
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": units["peak_mem_gib"]}
    driver.release()
    numbers = driver.check()
    correct, checks = judge(numbers, cell.limits, failed)
    found = foreign_modules()
    if found:
        print(f"portbench: foreign modules loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": cell.chips, "memory_peak_bytes": peak,
                         "power_limit": power_limit(), **extra}}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
