#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, many seeds in
one process (the benchmark's own runs never run this).

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --what program
    python3 portbench/control.py --workload NAME --seeds 1,2,3 --what control
    python3 portbench/control.py --workload NAME --seeds 1,2,3 --what half_batch

``program``: the numbers a sound run compares, after set-up and, for
serving, one cycle of the traffic's lengths at the cell's load (so the
longest prompt is served). ``control``: the same numbers with the
reference at fp8 (``reference.common.LowP``) in the port's place. A
fault's name (``faults.FAULTS``): the port with that fault planted. One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, what: str, device) -> dict:
    from portbench import faults, spec
    from portbench.reference.common import LowP
    driver = spec.mode_module(cell.traffic).Driver(cell, seed, device)
    plant = faults.FAULTS[what]() if what in faults.FAULTS else None
    if plant is not None:
        plant.__enter__()
    try:
        driver.setup()
        if hasattr(driver, "table"):
            driver._serve(lambda n, elapsed: n > 0, mark=False)
    finally:
        if plant is not None:
            plant.__exit__(None, None, None)
    driver.release()
    numbers = driver.check(LowP() if what == "control" else None)
    return {"numbers": numbers, **({"detail": driver.detail} if hasattr(driver, "detail") else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import spec
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(spec.load_benchmark(ROOT), ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.what, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "what": args.what, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
