"""Shared by the port's multi-process CPU tests on a mesh
(tests/test_torch_serve_mesh.py, tests/test_torch_moe_mesh.py,
tests/test_torch_pipeline.py; pytest does not collect this module).

``spawn_ranks`` runs a test file as a script in ``WORLD`` gloo worker
processes with one torch thread each (as tests/test_torch_distributed.py
does); each worker calls ``init_rank`` and rank 0 calls ``save``. The
workers import no JAX. ``reference_runs`` runs tests/torch_mesh_reference.py
(the reference on 8 host devices) in a subprocess (``start_reference`` and
``reference_results`` run it beside the workers).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8


def _env(tmp: Path, **extra):
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo", "HOME": str(tmp),
            "TMPDIR": str(tmp), **extra}


def spawn_ranks(script: str, tmp: Path, timeout: float = 300):
    """Run ``script RANK TMP`` in WORLD processes; (results, arrays) that
    rank 0 saved. A failed worker's log tail is the assertion message."""
    procs = []
    for r in range(WORLD):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, script, str(r), str(tmp)],
                                       env=_env(tmp), stdout=log, stderr=subprocess.STDOUT),
                      log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    assert not bad, (tmp / f"rank{bad[0]}.log").read_text()[-4000:]
    return json.loads((tmp / "results.json").read_text()), dict(np.load(tmp / "arrays.npz"))


def start_reference(tmp: Path, *cases: str):
    """tests/torch_mesh_reference.py's ``cases`` (inputs ``tmp/<case>_in.npz``)
    started in a subprocess; ``reference_results`` waits for them."""
    log = open(tmp / "reference.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_reference.py"),
                             str(tmp), *cases], stdout=log, stderr=subprocess.STDOUT,
                            env=_env(tmp, JAX_PLATFORMS="cpu"))
    return proc, log, tmp, cases


def reference_results(started, timeout: float = 300):
    """{case: its arrays} of a ``start_reference`` run."""
    proc, log, tmp, cases = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert proc.returncode == 0, (tmp / "reference.log").read_text()[-4000:]
    return {c: dict(np.load(tmp / f"{c}.npz")) for c in cases}


def reference_runs(tmp: Path, *cases: str, timeout: float = 300):
    """tests/torch_mesh_reference.py's ``cases`` (inputs ``tmp/<case>_in.npz``);
    {case: its arrays}."""
    return reference_results(start_reference(tmp, *cases), timeout)


def init_rank(rank: int, tmp: Path) -> None:
    """One torch thread; the default process group over gloo (a FileStore
    under ``tmp``)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(str(tmp / "store"), WORLD))


def save(rank: int, tmp: Path, results: dict, arrays: dict) -> None:
    """Rank 0 writes the results; every rank then leaves the group."""
    import torch.distributed as dist
    if rank == 0:
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "results.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


class Clock:
    """Prints each case's time since the start to the rank's log."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, tag: str) -> None:
        print(f"{tag} {time.perf_counter() - self.t0:.1f} s", flush=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = val
    return tree
