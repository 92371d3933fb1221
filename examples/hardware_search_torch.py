"""Hardware x parallelism co-search (paper §VI / Table VI exploration).

Sweeps tile compute, inter-tile NoC bandwidth, and the inter-tile grid
shape of the wafer-scale config *jointly* with the parallelism plan, and
prints the ranked hardware x plan points plus the JSON round-trip of the
winning machine — the whole loop the declarative hardware API opens. The
PyTorch/CUDA port's counterpart of ``examples/hardware_search.py``; the
sweep runs on ``--device`` (the card by default):

    PYTHONPATH=src python examples/hardware_search_torch.py
    PYTHONPATH=src python examples/hardware_search_torch.py --tiny --device cpu   # CI smoke
"""

import argparse

from repro_torch.api import (
    Experiment,
    HardwareSearchSpace,
    HardwareSpec,
    SearchSpace,
    resolve_hardware,
)


def main(tiny: bool = False, device: str = "cuda"):
    if tiny:
        base = resolve_hardware("tpu_v5e_2x2")
        hw_search = HardwareSearchSpace(tile_flops=(100e12, 197e12))
        search = SearchSpace(max_plans=3, microbatch_sizes=(1,))
        batch, seq = 8, 128
    else:
        base = resolve_hardware("wafer_scale")
        hw_search = HardwareSearchSpace(
            tile_flops=(8e12, 16e12, 32e12),
            inter_bw=(128e9, 256e9),
            mesh_shapes=((5, 4), (4, 4)),       # inter-tile grid variants
        )
        search = SearchSpace(max_plans=8, microbatch_sizes=(1, 2))
        batch, seq = 64, 2048

    exp = Experiment(arch="yi-6b", hardware=base, search=search,
                     hardware_search=hw_search, global_batch=batch,
                     seq_len=seq)
    report = exp.sweep(device=device)
    print(f"hardware x parallelism search: {report.arch} on {report.hardware}")
    print(f"  {report.num_hardware} hardware variants x "
          f"{report.num_candidates // max(1, report.num_hardware)} plans each, "
          f"{report.num_failed} failed")
    print(report.table(top=10))

    best = report.best
    print(f"\nwinning machine: {best.hardware} "
          f"({best.throughput:.2f} samples/s with pp={best.plan.pp} "
          f"dp={best.plan.dp} tp={best.plan.tp})")

    # the winner is data: dump it, reload it, and it simulates identically
    winner = next(s for s in hw_search.enumerate_specs(base)
                  if s.name == best.hardware)
    text = winner.to_json(indent=2)
    assert HardwareSpec.from_json(text).to_dict() == winner.to_dict()
    print(f"winner serializes to {len(text)} bytes of JSON "
          "(python -m repro_torch hardware / --hardware-json compatible)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-scale config for CI smoke runs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the batched fast tier replays: the card "
                         "(default; an error without one) or the CPU")
    main(**vars(ap.parse_args()))
