"""Guided hardware/parallelism co-design (paper §VI on a budget).

Where ``examples/codesign_torch.py`` exhaustively ranks every (hardware
variant x parallel plan) point, this drives the same loop through
``repro_torch.search``: successive halving climbs the simulation-fidelity
ladder (analytical NoC + 2 microbatches -> macro NoC + 4 microbatches ->
full fidelity), spending the expensive full-fidelity simulations only on
candidates the cheap rungs rank near the top. The exhaustive loop runs
too, so the script prints the quality/cost trade side by side. The
PyTorch/CUDA port's counterpart of ``examples/guided_codesign.py``: the
guided search's reduced rungs replay on ``--device`` (the card by
default); the exhaustive loop is host code.

    PYTHONPATH=src python examples/guided_codesign_torch.py
    PYTHONPATH=src python examples/guided_codesign_torch.py --tiny --device cpu   # CI smoke
"""

import argparse
import dataclasses

from repro_torch.api import (
    HardwareSearchSpace,
    PlannerCfg,
    plan_codesign,
    resolve_hardware,
)
from repro_torch.configs import get_config


def main(tiny: bool = False, workers: int = 0, seed: int = 0, device: str = "cuda"):
    arch = get_config("yi-6b")
    if tiny:
        base = resolve_hardware("tpu_v5e_2x2")
        cfg = PlannerCfg(
            global_batch=8, seq_len=128, max_plans=4, microbatch_sizes=(1,),
            hardware_search=HardwareSearchSpace(
                tile_flops=(100e12, 197e12),
                dram_bandwidth=(400e9, 819e9)),
            workers=workers,
        )
    else:
        base = resolve_hardware("tpu_v5e_2x2")
        cfg = PlannerCfg(
            global_batch=16, seq_len=256, max_plans=8,
            microbatch_sizes=(1, 2),
            hardware_search=HardwareSearchSpace(
                tile_flops=(50e12, 100e12, 197e12),
                intra_bw=(25e9, 50e9),
                dram_bandwidth=(400e9, 819e9),
                max_specs=64),
            workers=workers,
        )

    exhaustive = plan_codesign(arch, base, cfg)       # today's full loop
    guided_cfg = dataclasses.replace(cfg, search_strategy="sh",
                                     search_seed=seed)
    guided = plan_codesign(arch, base, guided_cfg, device=device)
    search = guided.report.search

    print(f"space: {exhaustive.report.num_candidates} joint candidates over "
          f"{exhaustive.report.num_hardware} hardware variants")
    print(f"exhaustive: {exhaustive.summary()}")
    print(f"guided sh:  {guided.summary()}")
    print(f"  {search.summary()}")
    print(f"  rungs: " + " -> ".join(
        f"{r.fidelity}[{r.evaluated}->{r.promoted}]" for r in search.rungs))
    quality = guided.throughput / exhaustive.throughput
    savings = exhaustive.report.num_candidates / max(1, search.full_fidelity_sims)
    print(f"  quality {quality:.1%} of the exhaustive optimum at "
          f"{savings:.1f}x fewer full-fidelity simulations")
    curve = ", ".join(f"({int(n)}: {t:.2f})" for n, t in search.best_curve)
    print(f"  best-so-far curve (full sims: samples/s): {curve}")

    assert quality >= 0.98, "guided search fell outside the 2% quality gate"
    # the default budget is a fifth of the space (rounded up); the strict
    # <= 1/5 acceptance gate runs in benchmarks/bench_search.py
    assert search.full_fidelity_sims <= search.budget


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-scale config for CI smoke runs")
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = serial; N = shared process pool of N")
    ap.add_argument("--seed", type=int, default=0,
                    help="search RNG seed (fixed seed = reproducible run)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the batched fast tier replays: the card "
                         "(default; an error without one) or the CPU")
    main(**vars(ap.parse_args()))
