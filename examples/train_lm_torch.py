"""End-to-end training with the PyTorch/CUDA port (``repro_torch``), the
counterpart of ``examples/train_lm.py``: a reduced architecture trained
for a few hundred steps through ``repro_torch.launch.train.main`` (the
prefetching data pipeline, Adam with its cosine schedule, checkpoints and
restart, the straggler monitor), on the card by default:

    PYTHONPATH=src python examples/train_lm_torch.py --arch yi-6b --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-2.7b --device cpu

Any of the 10 archs works. Checkpoints go to ``--ckpt-dir`` (by default
``ckpt_torch_<arch>`` in the temporary directory), and a second run
resumes from them.
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", default="small", choices=["tiny", "small", "full"])
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or str(Path(tempfile.gettempdir()) / f"ckpt_torch_{args.arch}")
    return train_main(["--arch", args.arch, "--scale", args.scale, "--steps", str(args.steps),
                       "--global-batch", str(args.global_batch), "--seq-len", str(args.seq_len),
                       "--microbatches", str(args.microbatches), "--ckpt-dir", ckpt,
                       "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
