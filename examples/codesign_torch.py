"""Hardware/parallelism co-design (paper §VI as a closed loop).

The planner and the hardware search run as *one* loop: the full
(hardware variant x parallel plan) product is flattened into a single
shared-pool sweep, ranked jointly, and the winner comes back as a
co-design recommendation — a full serializable HardwareSpec plus the
best plan on it (the "inspire the design of future accelerators" loop).
The PyTorch/CUDA port's counterpart of ``examples/codesign.py``. It takes
no ``--device``: the exhaustive planner's experiments run the event
engine, which never batches, so ``plan_codesign`` is host code here and
refuses a device (``examples/guided_codesign_torch.py`` has one).

    PYTHONPATH=src python examples/codesign_torch.py
    PYTHONPATH=src python examples/codesign_torch.py --tiny   # CI smoke
"""

import argparse

from repro_torch.api import (
    HardwareSearchSpace,
    HardwareSpec,
    PlannerCfg,
    plan_codesign,
    resolve_hardware,
)
from repro_torch.configs import get_config


def main(tiny: bool = False, workers: int = 0):
    if tiny:
        arch = get_config("yi-6b")
        base = resolve_hardware("tpu_v5e_2x2")
        cfg = PlannerCfg(
            global_batch=8, seq_len=128, max_plans=3,
            microbatch_sizes=(1,),
            hardware_search=HardwareSearchSpace(tile_flops=(100e12, 197e12)),
            workers=workers,
        )
    else:
        arch = get_config("yi-6b")
        base = resolve_hardware("wafer_scale")
        cfg = PlannerCfg(
            global_batch=64, seq_len=2048, max_plans=8,
            microbatch_sizes=(1, 2),
            hardware_search=HardwareSearchSpace(
                tile_flops=(8e12, 16e12, 32e12),
                inter_bw=(128e9, 256e9),
                mesh_shapes=((5, 4), (4, 4)),   # inter-tile grid variants
            ),
            workers=workers,
        )

    res = plan_codesign(arch, base, cfg)
    report = res.report
    print(f"co-design: {report.arch} over {report.num_hardware} hardware "
          f"variants x plans ({report.num_candidates} joint candidates, "
          f"{report.num_failed} failed; {report.executor})")
    print(report.table(top=8))
    print(f"\nrecommendation: {res.summary()}")

    # the recommendation is data: the winning machine dumps to
    # --hardware-json compatible JSON and reloads losslessly
    text = res.hardware.to_json(indent=2)
    assert HardwareSpec.from_json(text).to_dict() == res.hardware.to_dict()
    print(f"winning hardware spec ({len(text)} bytes of JSON):")
    print(text)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-scale config for CI smoke runs")
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = serial; N = shared process pool of N")
    main(**vars(ap.parse_args()))
