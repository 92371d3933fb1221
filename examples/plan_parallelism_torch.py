"""Reproduce the paper's §V-B parallelism exploration on an assigned
architecture: sweep (pp, dp, tp, layout, comm placement) with the typed
Experiment API of the PyTorch/CUDA port (``repro_torch.api``) and print
the ranked table (Fig. 8/10 style); the counterpart of
``examples/plan_parallelism.py``, its sweeps on ``--device`` (the card by
default).

    PYTHONPATH=src python examples/plan_parallelism_torch.py --arch dbrx-132b
    PYTHONPATH=src python examples/plan_parallelism_torch.py --arch yi-6b --workers 8
"""

import argparse

from repro_torch.api import Experiment, Layout, SearchSpace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = serial; N = process-pool sweep")
    ap.add_argument("--json", default=None, help="write SweepReport JSON here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the batched fast tier replays: the card "
                         "(default; an error without one) or the CPU")
    args = ap.parse_args()

    # the paper's exploration grid: pp in {10, 20}, 16-way (dp x tp) splits,
    # both layouts, both TP comm-group placements (comm1/comm2). Each dp
    # group gets global_batch = 64 * dp so every plan runs the same 64
    # microbatches per replica (constant bubble fraction across dp) —
    # one Experiment per dp, merged into a single ranking.
    report = None
    for tp in (1, 2, 4, 8):
        dp = 16 // tp
        exp = Experiment(
            arch=args.arch,
            hardware="wafer_scale",
            search=SearchSpace(degrees=[(pp, dp, tp) for pp in (10, 20)],
                               layouts=(Layout.S_SHAPE, Layout.LINE),
                               tp_contiguous=(True, False),
                               microbatch_sizes=(1,),
                               max_plans=16),
            seq_len=args.seq_len,
            global_batch=64 * dp,
        )
        part = exp.sweep(workers=args.workers, device=args.device)
        if report is None:
            report = part
        else:
            report.runs.extend(part.runs)
            report.num_candidates += part.num_candidates
            report.num_pruned_memory += part.num_pruned_memory
            report.num_failed += part.num_failed
    report.runs.sort(key=lambda r: -r.throughput)

    print(f"== {report.arch} on {report.hardware} "
          f"({report.executor}; {report.num_candidates} candidates, "
          f"{report.num_failed} infeasible) ==")
    print(report.table(top=12))
    best = report.best
    p = best.plan
    print(f"\nbest plan: pp={p.pp} dp={p.dp} tp={p.tp} {p.layout} "
          f"{'comm1' if p.tp_contiguous else 'comm2'} "
          f"-> {best.throughput:.3f} samples/s")
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.to_json(indent=2) + "\n")
        print(f"[report written to {args.json}]")


if __name__ == "__main__":
    main()
