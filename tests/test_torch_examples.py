"""The port's examples (``examples/train_lm_torch.py``,
``examples/serve_lm_torch.py``) run end to end on the CPU at their
smallest settings, each in a subprocess with a timeout: training with a
checkpoint and a resumed run, serving on one device and on a (1, 2) mesh
of two gloo processes under torchrun, which must generate the same
tokens."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--scale", "tiny"]


def _run(args, timeout=240):
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    r = subprocess.run([sys.executable, "-W", "ignore", *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_train_example_trains_and_resumes(tmp_path):
    args = ["examples/train_lm_torch.py", *SMALL, "--global-batch", "4", "--seq-len", "16",
            "--microbatches", "2", "--ckpt-dir", str(tmp_path)]
    out = _run([*args, "--steps", "50"])           # the loop checkpoints every 50 steps
    assert "step 0: loss=" in out and "done: loss" in out
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
    assert "[restore] resumed from step 50" in _run([*args, "--steps", "51"])


def _first_sequence(out):
    return [line for line in out.splitlines() if line.startswith("first sequence:")]


def test_serve_example_on_one_device_and_a_mesh():
    args = ["examples/serve_lm_torch.py", *SMALL, "--batch", "2", "--prompt-len", "4",
            "--new-tokens", "4"]
    single = _run(args)
    assert "generated (2, 4)" in single
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    meshed = _run(["-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
                   "localhost", "--master-port", str(port), *args, "--mesh", "1,2"])
    assert "on a (1, 2) mesh" in meshed
    assert _first_sequence(meshed) == _first_sequence(single) != []


def test_serve_example_serves_the_first_layers():
    """``--layers`` cuts the depth at the scale's widths (the way one card
    serves full-width nemotron-4-340b: ``--scale full --layers 8``)."""
    out = _run(["examples/serve_lm_torch.py", *SMALL, "--arch", "nemotron-4-340b", "--layers",
                "1", "--batch", "2", "--prompt-len", "4", "--new-tokens", "4"])
    assert "nemotron-4-340b (L=1): generated (2, 4)" in out
