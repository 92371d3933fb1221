"""The port's examples run end to end on the CPU at their smallest
settings, each in a subprocess with a timeout. The model substrate's
(``examples/train_lm_torch.py``, ``examples/serve_lm_torch.py``):
training with a checkpoint and a resumed run, serving on one device, on a
(1, 2) mesh of two gloo processes under torchrun and on the mesh
``--plan-mesh`` picks, which must generate the same tokens. The
simulator's (``examples/{quickstart,plan_parallelism,hardware_search,
codesign,trace_analysis,guided_codesign}_torch.py``): each beside the
reference's example on the same flags, with the same standard output
line for line (the package's name aside) and the same files."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--scale", "tiny"]


def _env():
    return {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}


def _run(args, timeout=240, rc=0):
    r = subprocess.run([sys.executable, "-W", "ignore", *args], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == rc, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout if rc == 0 else r.stderr


def _torchrun(nproc, args):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return _run(["-m", "torch.distributed.run", "--nproc-per-node", str(nproc), "--master-addr",
                 "localhost", "--master-port", str(port), *args])


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
    meshed = _torchrun(2, [*args, "--mesh", "1,2"])
    assert "on a (1, 2) mesh" in meshed
    assert _first_sequence(meshed) == _first_sequence(single) != []


def test_serve_example_serves_the_first_layers():
    """``--layers`` cuts the depth at the scale's widths (the way one card
    serves full-width nemotron-4-340b: ``--scale full --layers 8``)."""
    out = _run(["examples/serve_lm_torch.py", *SMALL, "--arch", "nemotron-4-340b", "--layers",
                "1", "--batch", "2", "--prompt-len", "4", "--new-tokens", "4"])
    assert "nemotron-4-340b (L=1): generated (2, 4)" in out


SERVE_TINY = ["examples/serve_lm_torch.py", *SMALL, "--batch", "2", "--prompt-len", "4",
              "--new-tokens", "4"]


def test_serve_example_on_the_planned_mesh():
    """``--plan-mesh --hardware tpu_v5e_1x2`` under torchrun with two gloo
    processes: ``plan_serving``'s split of the two devices, and the single
    device's tokens."""
    from repro_torch.serving import plan_serving
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    mesh_axes, _ = plan_serving(scale_arch(get_config("yi-6b"), "tiny"), hardware="tpu_v5e_1x2",
                                batch=2, context_len=8)
    single = _run(SERVE_TINY)
    planned = _torchrun(2, [*SERVE_TINY, "--plan-mesh", "--hardware", "tpu_v5e_1x2"])
    assert f"plan_serving on tpu_v5e_1x2: mesh {mesh_axes} (" in planned
    assert f"on a {(mesh_axes['data'], mesh_axes['model'])} mesh" in planned
    assert _first_sequence(planned) == _first_sequence(single) != []


def test_serve_example_plan_mesh_needs_the_hardware_world_size():
    """``--plan-mesh`` never shrinks the split: a world size other than
    the hardware's device count exits with both numbers; ``--mesh`` beside
    it is a usage error."""
    err = _run([*SERVE_TINY, "--plan-mesh", "--hardware", "tpu_v5e_2x2"], rc=1)
    assert "tpu_v5e_2x2 has 4 devices but this run has 1 processes" in err
    err = _run([*SERVE_TINY, "--plan-mesh", "--mesh", "1,2"], rc=2)
    assert "does not go with --mesh" in err


# script -> (arguments, whether the port's takes --device); the files an
# example writes go under the directory that replaces OUT
OUT = "{out}"
SIMULATOR_EXAMPLES = {
    "quickstart": (["--tiny"], True),
    "plan_parallelism": (["--arch", "yi-6b", "--seq-len", "128", "--json", OUT + "/pp.json"],
                         True),
    "hardware_search": (["--tiny"], True),
    "codesign": (["--tiny"], False),
    "trace_analysis": (["--tiny", "--out", OUT], False),
    "guided_codesign": (["--tiny"], True),
}


@pytest.mark.parametrize("name", sorted(SIMULATOR_EXAMPLES))
def test_simulator_example_equals_reference(name, tmp_path):
    """The port's example and the reference's, started together on the same
    flags (the port's on ``--device cpu`` where it takes one): the same
    lines of standard output, ``repro_torch`` read as ``repro`` and each
    run's output directory as ``{out}``, and the same files. None of them
    prints wall clock. ``plan_parallelism`` has no small setting of its
    own: yi-6b at sequence 128 is its smallest (~100 s each on a CPU)."""
    args, takes_device = SIMULATOR_EXAMPLES[name]
    runs = {}
    for side, script in (("ref", f"{name}.py"), ("port", f"{name}_torch.py")):
        out = tmp_path / side
        out.mkdir()
        argv = [a.replace(OUT, str(out)) for a in args]
        if side == "port" and takes_device:
            argv += ["--device", "cpu"]
        runs[side] = (out, subprocess.Popen(
            [sys.executable, "-W", "ignore", f"examples/{script}", *argv], env=_env(),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    texts = {}
    for side, (out, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{side}: {stderr[-4000:]}"
        texts[side] = stdout.replace(str(out), OUT).replace("repro_torch", "repro").splitlines()
    assert texts["port"] == texts["ref"] and texts["port"]
    ref_files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ref_files
    for f in ref_files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
