"""Quickstart: simulate LLM training on a wafer-scale tiled accelerator
with PALM and let the planner pick the parallelism — all through the
typed Experiment API of the PyTorch/CUDA port (``repro_torch.api``), the
counterpart of ``examples/quickstart.py``. The sweep builds a
``SweepEngine`` on ``--device`` (the card by default):

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --tiny --device cpu   # CI smoke config
"""

import argparse

from repro_torch.api import Experiment, Layout, ParallelPlan, Schedule, SearchSpace
from repro_torch.core import transformer_lm_graph


def main(tiny: bool = False, device: str = "cuda"):
    # --- 1. one simulation ---
    if tiny:
        # smoke config: 4-layer toy transformer on a 4-chip pod
        hardware = "tpu_v5e_2x2"
        plan = ParallelPlan(pp=2, dp=2, tp=1, microbatch=1, global_batch=8,
                            schedule=Schedule.ONE_F_ONE_B, layout=Layout.S_SHAPE)
        builder = lambda p: transformer_lm_graph(
            "T-tiny", 4, 256, 4, seq_len=128,
            batch=p.microbatch * p.dp, vocab=1024, gated_mlp=False)
        name = "T-tiny on tpu_v5e_2x2"
    else:
        # T-18B, the paper's §V-B baseline plan, on the Table VI wafer
        hardware = "wafer_scale"   # 5x4 tiles of 4x4 cores
        plan = ParallelPlan(pp=20, dp=2, tp=8, microbatch=1, global_batch=256,
                            schedule=Schedule.ONE_F_ONE_B, layout=Layout.S_SHAPE)
        builder = lambda p: transformer_lm_graph(
            "T-18B", 40, 6144, 48, seq_len=2048,
            batch=p.microbatch * p.dp, vocab=51200, gated_mlp=False)
        name = "T-18B on wafer-scale"

    rep = Experiment(hardware=hardware, plan=plan, graph_builder=builder).run()
    print(f"{name}: {rep.throughput:.2f} samples/s, "
          f"bubble {rep.bubble_ratio:.1%}, "
          f"peak stage memory {rep.peak_memory_bytes / 1e9:.2f} GB, "
          f"{rep.event_count} events")

    # --- 2. PALM as auto-parallelism planner for an assigned arch ---
    sweep = Experiment(
        arch="yi-6b",
        hardware="tpu_v5e_2x2" if tiny else "wafer_scale",
        search=SearchSpace(max_plans=4 if tiny else 12,
                           microbatch_sizes=(1, 2)),
        global_batch=16 if tiny else 128,
        seq_len=128 if tiny else 2048,
    ).sweep(device=device)
    print(f"\nplanner ranking for {sweep.arch} (top 5):")
    print(sweep.table(top=5))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-scale config for CI smoke runs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the batched fast tier replays: the card "
                         "(default; an error without one) or the CPU")
    main(**vars(ap.parse_args()))
