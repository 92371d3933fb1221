"""Columnar trace analytics: simulate a training pipeline, inspect its
event timeline (per-stage utilization, bubble fraction, critical path,
NoC/DRAM occupancy), and export it for Chrome/Perfetto. The PyTorch/CUDA
port's counterpart of ``examples/trace_analysis.py``. It takes no
``--device``: one ``Experiment.run()`` on the event engine is host code.

    PYTHONPATH=src python examples/trace_analysis_torch.py
    PYTHONPATH=src python examples/trace_analysis_torch.py --tiny   # CI smoke

The same schema comes out of every PALM entry point — training sweeps
(``Experiment.sweep(return_timelines=True)``), serving planning
(``plan_serving(collect_timeline=True)``), the CLI
(``python -m repro_torch simulate --trace-out``), and the dry-run
(``python -m repro_torch.launch.dryrun --palm-trace``) — so any two timelines
load side by side in one ui.perfetto.dev view.
"""

import argparse
import json
from pathlib import Path

from repro_torch.api import Experiment, ParallelPlan, chrome_trace
from repro_torch.core import KIND_DRAM, KIND_FD, KIND_NOC
from repro_torch.core.trace import KIND_NAMES


def main(tiny: bool = False, out_dir: Path = Path("artifacts")):
    arch = "yi-6b"
    hardware = "tpu_v5e_2x2" if tiny else "grayskull"
    plan = (ParallelPlan(pp=2, dp=2, tp=1, microbatch=1, global_batch=8)
            if tiny else
            ParallelPlan(pp=4, dp=2, tp=2, microbatch=2, global_batch=64))
    rep = Experiment(arch=arch, hardware=hardware, plan=plan,
                     seq_len=128 if tiny else 1024,
                     global_batch=plan.global_batch,
                     collect_timeline=True).run()
    trace = rep.trace

    print(f"{arch} on {hardware}: {rep.throughput:.2f} samples/s, "
          f"{len(trace)} trace events over {trace.total_time * 1e3:.2f} ms")

    # --- per-stage utilization & bubble ---
    print("\nper-stage utilization (FD+BD+GU):")
    for s, u in trace.stage_utilization().items():
        print(f"  stage {s}: {'#' * int(40 * u):<40s} {u:6.1%}")
    print(f"bubble fraction: {trace.bubble_fraction():.1%}")

    # --- critical path: which events bound the iteration ---
    path = trace.critical_path()
    busy = sum(r.duration for r in path)
    print(f"\ncritical path: {len(path)} events, "
          f"{busy / trace.total_time:.0%} of the horizon is on-chain work")
    for r in path[:3] + path[-3:]:
        print(f"  stage {r.stage} {KIND_NAMES[r.kind]:>4s} mb{r.micro}: "
              f"{r.start * 1e6:9.1f} -> {r.end * 1e6:9.1f} us")

    # --- resource lanes ---
    for kind, label in ((KIND_NOC, "NoC links"), (KIND_DRAM, "DRAM channels")):
        occ = trace.resource_occupancy(kind)
        if occ:
            hottest = max(occ, key=occ.get)
            print(f"{label}: {len(occ)} busy, hottest id {hottest} "
                  f"at {occ[hottest]:.1%}")

    # --- slicing: the warmup phase only ---
    warmup = trace.slice_time(0.0, trace.total_time / 4)
    fd_share = len(warmup.filter(kinds=(KIND_FD,))) / max(1, len(warmup))
    print(f"first quarter of the run: {len(warmup)} events, "
          f"{fd_share:.0%} forward")

    # --- export: Perfetto JSON + columnar npz ---
    out_dir.mkdir(parents=True, exist_ok=True)
    perfetto = out_dir / "trace_analysis.json"
    perfetto.write_text(json.dumps(chrome_trace(trace, label=arch)))
    print(f"\nwrote {perfetto} (load in chrome://tracing or ui.perfetto.dev)")
    try:
        npz = out_dir / "trace_analysis.npz"
        trace.to_npz(npz)
        print(f"wrote {npz} ({npz.stat().st_size} B for "
              f"{trace.nbytes} B of columns)")
    except RuntimeError:
        print("numpy unavailable: skipped the .npz export")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-scale CI smoke configuration")
    ap.add_argument("--out", type=Path, default=Path("artifacts"))
    args = ap.parse_args()
    main(tiny=args.tiny, out_dir=args.out)
