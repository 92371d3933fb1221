"""The port's sharded train step, prefill, checkpoint and resharding on an
8-rank 2x4 ("data", "model") CPU mesh (gloo), against the port's
single-device step and, for yi-6b, the reference's.

Eight worker processes run this file as a script (``_worker``): each
rendezvouses through a ``FileStore`` under the test's tmp dir, runs every
case below with one torch thread, and rank 0 writes the results (masters
gathered whole) to that dir. The workers import no JAX; this process
computes the single-device and JAX sides and compares.

Cases (tiny archs, G = 2 microbatches of 2 x 24 tokens, ``seed=3`` data):
yi-6b from the reference's init (fp32: against JAX's step too),
mamba2-2.7b, hymba-1.5b and hubert-xlarge from the port's init rescaled to
fan-in H (``FAN_IN_H``), each in fp32, and all four in bf16 on fan-in-H
weights; ``seq_shard`` and remat (recompute in the backward) for yi-6b,
mamba2-2.7b and hymba-1.5b; yi-6b on a 1x8 mesh, where its 4 heads do not
divide the model axis (attention gathered whole), and on a (2, 2, 2)
("pod", "data", "model") mesh; hymba-1.5b on 1x8 (its 8 SSM heads one a
rank, its 4 attention heads whole); mamba2-2.7b with 6 SSM heads
(d_inner 192) on 2x4, where the heads do not divide the model axis and
the mixer is computed whole;
``elastic_reshard`` and a checkpoint from 2x4 onto a 2x2 mesh of ranks
0-3; prefill and the eval step on 2x4. The MoE archs on a mesh are
tests/test_torch_moe_mesh.py's.
On 2x4 tiny yi-6b's 2 kv heads do not divide the 4-way model axis: its
kv projections are gathered and each rank takes its q head's kv head.
The SSM mixer of tiny mamba2-2.7b and hymba-1.5b (8 heads of hp 32, N 16)
is head parallel on 2x4 and 1x8 (``Block.ssm_tp``): the shapes each rank
computes with are recorded (in_proj's columns, the scan's heads,
out_proj's rows). The fp32 mamba2-2.7b step on 2x4 is also held against
the reference's own step on a 2x4 mesh of 8 host devices
(tests/torch_mesh_reference.py's ``train``) from the same weights, at
the fp32 bounds below. The sharded gated RMSNorm
(``layers.rmsnorm_sharded``, 64 of 256 columns a rank) and its gradients
are held against ``kernels.ref.rmsnorm_ref`` of whole rows: fp32 within
1e-5 relative and 1e-6 absolute, fp64 within 1e-12.

Bounds. fp32: loss 1e-5 relative, grad norm 1e-3, masters as
tests/torch_train_common.py's G=2 step (1e-6, 2 lr where |clipped
gradient| < 100 eps; under the reference's init the (2, 2, 2) mesh's
replicated batch read 1.1e-5 on the norm, by rounding), and each leaf's
gradient (read from the first moment: Adam's first step hides a
gradient's scale from the masters) at that file's relative L2, 1e-4 under
fan-in H (read: 1.1e-6) and 1e-3 under the reference's init (read:
4.0e-5). bf16: loss and masters at the reference's own sharded bounds
(tests/test_distributed.py:139-140: 1e-3 relative, 5e-2); the gradient no
further from the single-device fp32 one than 1.25x the single-device bf16
one is, as a whole (read: 1.005-1.104x) and 2.5x a leaf (read: 1.29x, and
1.88x on hymba's 8-element A_log, whose single-device bf16 distance is
0.016); each master's change (after minus before) within 0.5 relative L2
of the single-device bf16 change (read: 0.25; a zeroed gradient reads
about 1, a flipped one 2). Prefill as tests/test_torch_serve.py (1e-4).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_common import reference_results, start_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
ARCHS = ("yi-6b", "mamba2-2.7b", "hymba-1.5b", "hubert-xlarge")
SSM_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
LR = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# archs whose fp32 step runs on fan-in-H weights, as tests/torch_train_common.py's
# STEP_INIT has them: under the reference's init (fan-in from the layer axis,
# ROADMAP §3) their fp32 gradients amplify rounding (hubert's wq and wk
# missed the master rule by summation order alone). Every bf16 step runs on
# fan-in-H weights: under the reference's init tiny yi-6b's bf16 gradients
# read 1.1-3.1 relative L2 from fp32, noise that would hide any fault
FAN_IN_H = ("mamba2-2.7b", "hymba-1.5b", "hubert-xlarge")
# fp32 gradients, each leaf against the single-device step's: relative L2
# 1e-4 under fan-in H and 1e-3 under the reference's init (yi-6b), the
# bounds of tests/torch_train_common.py
GRAD_FP32 = {n: 1e-4 if n in FAN_IN_H else 1e-3 for n in ARCHS}


def _arch(name, heads=None):
    """Tiny ``name``; ``heads``: that many SSM heads (d_inner = heads x hp)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    arch = scale_arch(get_config(name), "tiny")
    return arch if heads is None else dataclasses.replace(arch, d_inner=heads * arch.ssm_headdim)


def _batch(arch):
    from repro_torch.train.data import DataCfg, SyntheticDataset
    return SyntheticDataset(arch, DataCfg(seq_len=24, global_batch=4, num_microbatches=2,
                                          seed=3)).batch_at(0)


def _cfg(dtype, seq_shard=False, remat=False):
    from repro_torch.models.lm import RunCfg
    from repro_torch.train import optim
    from repro_torch.train.step import TrainCfg
    return TrainCfg(run=RunCfg(compute_dtype=DTYPES[dtype], remat=remat, seq_shard=seq_shard),
                    opt=optim.OptimizerCfg(**LR), num_microbatches=2)


def _state(name, dtype, mesh=None, params=None, seq_shard=False, fan_in_h=None, heads=None):
    """A train state of tiny ``name`` (``heads``: ``_arch``'s): the port's
    init (seed 9), rescaled to fan-in H where ``fan_in_h`` (default: the
    archs of ``FAN_IN_H``, and every arch in bf16), or the reference's tree
    ``params``."""
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train.step import init_train_state
    from repro_torch.parallel.comm import local
    from repro_torch.train.step import sync_model
    arch = _arch(name, heads)
    state = init_train_state(arch, _cfg(dtype, seq_shard), torch.Generator().manual_seed(9),
                             "cpu", mesh=mesh)
    if fan_in_h is None:
        fan_in_h = name in FAN_IN_H or dtype == "bfloat16"
    if params is not None:
        zeros = {"m": params, "v": params, "step": np.int32(0)}
        zeros = {k: _zeros_like(v) for k, v in zeros.items()}
        train_state_from_numpy(state, {"params": params, "opt_state": zeros})
    elif fan_in_h:
        f = (arch.num_layers / arch.d_model) ** 0.5
        with torch.no_grad():
            for n, t in state.params.items():
                if n.split(".")[-1] in ("wq", "wk", "wv", "wi", "wg", "in_proj"):
                    local(t).mul_(f)
        sync_model(state)
    return arch, state


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return np.zeros_like(np.asarray(tree))


def _step(name, dtype, mesh=None, params=None, seq_shard=False, remat=False, fan_in_h=None,
          heads=None):
    """(state after one G=2 step, metrics)."""
    from repro_torch.train.step import make_train_step
    arch, state = _state(name, dtype, mesh, params, seq_shard, fan_in_h, heads)
    return make_train_step(arch, _cfg(dtype, seq_shard, remat), mesh)(state, _batch(arch))


def _whole(named):
    """{name: fp32 numpy} of a dict of tensors, DTensors gathered (every
    rank of their mesh calls this)."""
    from repro_torch.parallel.comm import is_dtensor
    out = {}
    for n, t in named.items():
        t = t.detach()
        out[n] = (t.full_tensor() if is_dtensor(t) else t).float().numpy()
    return out


def _mixer_shapes(model):
    """What each rank's SSM mixers compute with, in one forward of this
    rank's rows: {"ssm_tp": per block, "in_proj": the [H, columns] each
    block multiplies by, "out_proj": its [rows, H], "scan": the x [B, S,
    heads, hp] of each ``ssd_scan`` call}."""
    from repro_torch.models import lm
    scans, plain = [], lm.ssd_scan

    def seen(x, *args, **kw):
        scans.append(list(x.shape))
        return plain(x, *args, **kw)

    weights = [blk._ssm_weights(True)[0] for blk in model.blocks]
    lm.ssd_scan = seen
    try:
        with torch.no_grad():
            model(torch.zeros(2, 8, dtype=torch.long))
    finally:
        lm.ssd_scan = plain
    return {"ssm_tp": [blk.ssm_tp for blk in model.blocks],
            "in_proj": [list(w["in_proj"].shape) for w in weights],
            "out_proj": [list(w["out_proj"].shape) for w in weights], "scan": scans}


NORM_DTYPES = ("float32", "float64")
NORM_SHAPE = (6, 256)           # [T, H]: H over the 4-way model axis


def _norm_inputs(dtype):
    """(x, w, cot) whole, numpy, from seed 13."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal(NORM_SHAPE)
    w = 1.0 + 0.3 * rng.standard_normal(NORM_SHAPE[1])
    cot = rng.standard_normal(NORM_SHAPE)
    return tuple(a.astype(dtype) for a in (x, w, cot))


def _sharded_norm(mesh, dtype):
    """``layers.rmsnorm_sharded`` of this model rank's columns, and the
    gradients of sum(out * cot) in x and w: each gathered whole over
    "model"."""
    from repro_torch.models.layers import rmsnorm_sharded
    from repro_torch.parallel.comm import MeshComm, gather_dim
    c = MeshComm(mesh)
    n = NORM_SHAPE[1] // c.size
    cols = slice(c.rank * n, (c.rank + 1) * n)
    x, w, cot = (torch.from_numpy(np.ascontiguousarray(a[..., cols])) for a in _norm_inputs(dtype))
    x.requires_grad_()
    w.requires_grad_()
    out = rmsnorm_sharded(x, w, NORM_SHAPE[1], c.group)
    (out * cot).sum().backward()
    whole = lambda t, dim: gather_dim(t.detach(), dim, c.group).numpy()
    return {"out": whole(out, 1), "dx": whole(x.grad, 1), "dw": whole(w.grad, 0)}


# ---------------------------------------------------------------------------
# the worker (a subprocess of this file run as a script; no JAX)
# ---------------------------------------------------------------------------

def _worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.parallel.sharding import ShardingPlanner
    from repro_torch.serving.serve import make_prefill_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import elastic_reshard
    from repro_torch.train.step import make_eval_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(str(tmp / "store"), WORLD))
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    results, arrays = {}, {}
    t0 = time.perf_counter()

    def keep(tag, metrics, state):
        print(f"{tag} {time.perf_counter() - t0:.1f} s", flush=True)
        results[tag] = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}
        if hasattr(state.model.blocks[0], "ssm"):
            results[tag]["mixer"] = _mixer_shapes(state.model)
        for n, a in _whole(state.params).items():
            arrays[f"{tag}|params|{n}"] = a
        for n, a in _whole(state.opt_state["m"]).items():
            arrays[f"{tag}|m|{n}"] = a

    ref = dict(np.load(tmp / "yi_params.npz"))
    tree = _unflatten(ref)
    yi, m = _step("yi-6b", "float32", mesh, params=tree)
    keep("yi-6b/float32", m, yi)
    # every leaf at the planner's placements: masters, both moments, model
    planner = ShardingPlanner(mesh, _arch("yi-6b"))
    want = planner.params(yi.model)
    got = {"params": yi.params, "m": yi.opt_state["m"], "v": yi.opt_state["v"],
           "model": dict(yi.model.named_parameters())}
    results["placements"] = {k: sorted(n for n, t in tree_.items()
                                       if tuple(t.placements) != want[n])
                             for k, tree_ in got.items()}
    results["placements_sharded"] = sum(any(p.is_shard() for p in pl) for pl in want.values())
    for name in ARCHS:
        for dtype in ("float32", "bfloat16"):
            if (name, dtype) != ("yi-6b", "float32"):
                state, m = _step(name, dtype, mesh)
                keep(f"{name}/{dtype}", m, state)
    state, m = _step("yi-6b", "float32", mesh, params=tree, seq_shard=True)
    keep("yi-6b/float32/seq", m, state)
    for name in SSM_ARCHS:
        state, m = _step(name, "float32", mesh, seq_shard=True)
        keep(f"{name}/float32/seq", m, state)
    # remat: each Block's gathers and Megatron collectives run again in the
    # backward's recompute
    state, m = _step("yi-6b", "float32", mesh, params=tree, remat=True)
    keep("yi-6b/float32/remat", m, state)
    for name in SSM_ARCHS:
        state, m = _step(name, "float32", mesh, remat=True)
        keep(f"{name}/float32/remat", m, state)
    state, m = _step("mamba2-2.7b", "float32", mesh, heads=6)
    keep("mamba2-2.7b/float32/6heads", m, state)
    line = make_mesh((1, WORLD), ("data", "model"), "cpu")
    state, m = _step("yi-6b", "float32", line)
    keep("yi-6b/float32/1x8", m, state)
    state, m = _step("hymba-1.5b", "float32", line)
    keep("hymba-1.5b/float32/1x8", m, state)
    pods = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    state, m = _step("yi-6b", "float32", pods, params=tree)
    keep("yi-6b/float32/2x2x2", m, state)

    # elastic reshard and a checkpoint, 2x4 -> 2x2 (ranks 0-3)
    small = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    moved = elastic_reshard({"params": yi.params, "opt_state": yi.opt_state}, yi.model.arch,
                            small)
    trees = train_state_to_numpy(yi)
    old = _whole(yi.params)
    ckpt.save_checkpoint(tmp / "ckpt", 1, trees, extra={"data_step": 1})
    if rank < 4:
        small_planner = ShardingPlanner(small, yi.model.arch)
        pl = small_planner.params(yi.model)
        results["reshard_placements"] = sorted(
            n for n, t in moved["params"].items() if tuple(t.placements) != pl[n])
        results["reshard_max_diff"] = max(
            float(np.abs(_whole({n: t})[n] - old[n]).max()) for n, t in moved["params"].items())
        restored, extra = ckpt.restore_checkpoint(tmp / "ckpt", 1,
                                                  small_planner.checkpoint(yi.model))
        _, back = _state("yi-6b", "float32", small)
        train_state_from_numpy(back, restored)
        again = train_state_to_numpy(back)
        results["ckpt_extra"] = extra
        results["ckpt_equal"] = _trees_equal(again, trees)
        results["ckpt_placements"] = sorted(
            n for n, t in back.params.items() if tuple(t.placements) != pl[n])
    dist.barrier()

    # the sharded gated norm and its gradients, 64 of 256 columns a model rank
    for dtype in NORM_DTYPES:
        for k, v in _sharded_norm(mesh, dtype).items():
            arrays[f"norm/{dtype}|{k}"] = v

    # prefill and the eval step on 2x4, from the port's init (seed 5)
    arch = _arch("yi-6b")
    run = RunCfg(compute_dtype=torch.float32, mesh=mesh)
    model = init_params(arch, torch.Generator().manual_seed(5), run)
    tokens = np.random.default_rng(0).integers(0, arch.vocab, (4, 12))
    arrays["prefill"] = make_prefill_step(model)({"tokens": tokens}).numpy()
    batch = {k: v[0] for k, v in _batch(arch).items()}
    results["eval_loss"] = float(make_eval_step(arch, None, mesh)(model, batch)["loss"])
    if rank == 0:
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "results.json").write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


def _unflatten(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = val
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _trees_equal(a, b) -> bool:
    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


# ---------------------------------------------------------------------------
# the tests (this process: single-device port and JAX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_yi():
    """The reference's tiny yi-6b init (``PRNGKey(0)``) as a flat numpy dict."""
    import jax
    from repro.configs import get_config
    from repro.launch.train import scale_arch
    from repro.models import lm as jlm
    arch = scale_arch(get_config("yi-6b"), "tiny")
    params = jax.tree.map(np.asarray, jlm.init_params(arch, jax.random.PRNGKey(0),
                                                      jlm.RunCfg()))
    return _flatten(params)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The reference's fp32 mamba2-2.7b step on a 2x4 mesh of 8 host
    devices (tests/torch_mesh_reference.py's ``train``), from the fan-in-H
    weights the workers start from, started in the background; the tmp
    dir the workers share and the started run."""
    from repro_torch.convert import train_state_to_numpy
    tmp = tmp_path_factory.mktemp("dist")
    name = "mamba2-2.7b"
    tree = train_state_to_numpy(_state(name, "float32")[1])["params"]
    inp = {f"{name}|tree|{k}": v for k, v in _flatten(tree).items()}
    inp.update({f"{name}|batch|{k}": v for k, v in _batch(_arch(name)).items()})
    np.savez(tmp / "train_in.npz", **inp)
    return tmp, start_reference(tmp, "train")


@pytest.fixture(scope="module")
def reference(ranks, mesh_run):
    """The reference's arrays of ``mesh_run``, after the workers."""
    return reference_results(mesh_run[1])["train"]


@pytest.fixture(scope="module")
def ranks(mesh_run, jax_yi):
    """Run the 8 workers (beside ``mesh_run``); (results, arrays) of rank 0."""
    tmp = mesh_run[0]
    np.savez(tmp / "yi_params.npz", **jax_yi)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo", "HOME": str(tmp),
           "TMPDIR": str(tmp)}
    procs = []
    for r in range(WORLD):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, str(r), str(tmp)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=300)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    assert not bad, (tmp / f"rank{bad[0]}.log").read_text()[-4000:]
    return json.loads((tmp / "results.json").read_text()), dict(np.load(tmp / "arrays.npz"))


def _single(tag, jax_yi):
    """The port's single-device step for a worker case ``tag``."""
    name, dtype = tag.split("/")[:2]
    params = _unflatten(jax_yi) if tag == "yi-6b/float32" else None
    return _step(name, dtype, params=params)


def _masters_close(got, want, lr, grads_like=None):
    """tests/torch_train_common.py's G=2 rule on every leaf: 1e-6, and 2 lr
    where the step turned on the gradient's last digits (|m| / (1 - b1) <
    100 eps, m being (1 - b1) x the clipped gradient after one step)."""
    bad = []
    for n, w in want.items():
        near = np.abs(grads_like[n]) / 0.1 < 100 * 1e-8
        if not (np.abs(got[n] - w) <= np.where(near, 2 * lr, 1e-6)).all():
            bad.append(n)
    return bad


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_of(moments, grad_norm):
    """{name: the step's gradient (the G=2 mean)} from the first moments
    after one step, m = (1 - b1) x the gradient clipped to norm 1. Adam's
    first step moves a weight by about lr x sign(gradient), whatever its
    scale: the moments, not the masters, show a gradient's size."""
    clip = min(1.0, 1.0 / (float(grad_norm) + 1e-9))
    return {n: a / (0.1 * clip) for n, a in moments.items()}


def _case_grads(results, arrays, tag, names):
    """``_grads_of`` of worker case ``tag``."""
    return _grads_of({n: arrays[f"{tag}|m|{n}"] for n in names}, results[tag]["grad_norm"])


def _grads_off(results, arrays, tag, state, metrics):
    """{leaf: relative L2} of the leaves whose gradient in worker case
    ``tag`` sits further than ``GRAD_FP32`` from the single-device step's
    (``state``, ``metrics``). Prints the worst leaf (``pytest -rP``)."""
    want = _grads_of(_whole(state.opt_state["m"]), metrics["grad_norm"])
    got = _case_grads(results, arrays, tag, want)
    rel = {n: _rel(got[n], want[n]) for n in want}
    worst = max(rel, key=rel.get)
    print(f"{tag}: gradient, worst leaf {worst} {rel[worst]:.3g}")
    return {n: r for n, r in rel.items() if r > GRAD_FP32[tag.split("/")[0]]}


@pytest.mark.parametrize("tag", [f"{n}/float32" for n in ARCHS])
def test_sharded_step_matches_single_device_fp32(ranks, jax_yi, tag):
    results, arrays = ranks
    state, m = _single(tag, jax_yi)
    r = results[tag]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    want = _whole(state.params)
    got = {n: arrays[f"{tag}|params|{n}"] for n in want}
    moments = _whole(state.opt_state["m"])
    assert not _masters_close(got, want, r["lr"], moments)
    assert not _grads_off(results, arrays, tag, state, m)


@pytest.mark.parametrize("tag", [f"{n}/bfloat16" for n in ARCHS])
def test_sharded_step_matches_single_device_bf16(ranks, jax_yi, tag):
    """The bf16 backward across ranks (bf16 partial gradients summed over
    "data", the Megatron all-reduces, hymba's SSM share): the sharded
    gradients no further from the single-device fp32 ones than 1.25x the
    single-device bf16 gradients are (the whole gradient) and 2.5x (each
    leaf); each master's change within 0.5 relative L2 of the
    single-device bf16 change; loss and masters at the reference's own
    bounds besides."""
    results, arrays = ranks
    name = tag.split("/")[0]
    r = results[tag]
    init = _whole(_state(name, "bfloat16")[1].params)
    single, m = _single(tag, jax_yi)
    fp32, m32 = _step(name, "float32", fan_in_h=True)
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-3)
    after = _whole(single.params)
    for n, w in after.items():
        assert np.abs(arrays[f"{tag}|params|{n}"] - w).max() < 5e-2, n
    g32 = _grads_of(_whole(fp32.opt_state["m"]), m32["grad_norm"])
    g16 = _grads_of(_whole(single.opt_state["m"]), m["grad_norm"])
    got = _case_grads(results, arrays, tag, g32)
    whole = lambda g: np.concatenate([g[n].ravel() for n in g32])
    ratio = _rel(whole(got), whole(g32)) / _rel(whole(g16), whole(g32))
    leaf = {n: _rel(got[n], g32[n]) / _rel(g16[n], g32[n]) for n in g32}
    moved = {n: _rel(arrays[f"{tag}|params|{n}"] - init[n], after[n] - init[n]) for n in init}
    worst, most = max(leaf, key=leaf.get), max(moved, key=moved.get)
    print(f"{tag}: gradient from fp32 {ratio:.4g}x the single-device bf16's; worst leaf "
          f"{worst} {leaf[worst]:.4g}x; master change, worst leaf {most} {moved[most]:.3g}")
    assert ratio <= 1.25
    assert leaf[worst] <= 2.5
    assert moved[most] <= 0.5


def test_sharded_yi_step_matches_jax(ranks, jax_yi):
    """The sharded step against the reference's single-device step, at
    test_train_step_g2_matches_jax's bounds."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.train import scale_arch
    from repro.models import lm as jlm
    from repro.train import optim as joptim
    from repro.train import step as jstep
    results, arrays = ranks
    jarch = scale_arch(get_config("yi-6b"), "tiny")
    jcfg = jstep.TrainCfg(run=jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=jnp.float32),
                          opt=joptim.OptimizerCfg(**LR), num_microbatches=2)
    params = _unflatten(jax_yi)
    batch = _batch(_arch("yi-6b"))
    grads = None
    for i in range(2):
        mb = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        (_, _), g = jax.value_and_grad(jlm.loss_fn, argnums=1, has_aux=True)(
            jarch, params, mb, jcfg.run)
        g = _flatten(jax.tree.map(np.asarray, g))
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    jp = jax.tree.map(jnp.asarray, params)
    jp, jo, jm = jstep.make_train_step(jarch, jcfg)(
        jp, joptim.init_opt_state(jcfg.opt, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    r = results["yi-6b/float32"]
    assert r["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-3)
    lr = float(jm["lr"])
    clip = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    want = _flatten(jax.tree.map(np.asarray, jp))
    near_zero = total = 0
    for n in _whole(_state("yi-6b", "float32")[1].params):
        path = "/".join(("layers", *n.split(".")[2:])) if n.startswith("blocks.") else n
        layer = int(n.split(".")[1]) if n.startswith("blocks.") else None
        w = want[path] if layer is None else want[path][layer]
        g = grads[path] / 2 if layer is None else grads[path][layer] / 2
        near = np.abs(g) * clip < 100 * 1e-8
        near_zero, total = near_zero + int(near.sum()), total + near.size
        got = arrays[f"yi-6b/float32|params|{n}"]
        assert (np.abs(got - w) <= np.where(near, 2 * lr, 1e-6)).all(), n
    assert near_zero <= 0.15 * total


def test_state_is_stored_at_the_planner_placements(ranks):
    results, _ = ranks
    assert results["placements"] == {"params": [], "m": [], "v": [], "model": []}
    assert results["placements_sharded"] > 0


@pytest.mark.parametrize("name", ["yi-6b", "hymba-1.5b", "mamba2-2.7b"])
def test_seq_shard_gives_the_same_loss(ranks, jax_yi, name):
    results, arrays = ranks
    off, on = results[f"{name}/float32"], results[f"{name}/float32/seq"]
    assert on["loss"] == pytest.approx(off["loss"], rel=1e-5)
    assert on["grad_norm"] == pytest.approx(off["grad_norm"], rel=1e-5)
    single, m = _single(f"{name}/float32", jax_yi)
    assert not _grads_off(results, arrays, f"{name}/float32/seq", single, m)


@pytest.mark.parametrize("name", ["yi-6b", "hymba-1.5b", "mamba2-2.7b"])
def test_sharded_step_with_remat(ranks, jax_yi, name):
    """Remat on (``RunCfg.remat``'s default): each Block's weight gathers,
    Megatron collectives, the SSM mixer's gated-norm sum and, for hymba,
    the fused mixers' entry and exit run again in the backward's
    recompute. Held to the fp32 rules above against the single-device
    step with remat off."""
    results, arrays = ranks
    tag = f"{name}/float32/remat"
    _fp32_case(results, arrays, tag, *_single(f"{name}/float32", jax_yi))


def _fp32_case(results, arrays, tag, single, m):
    """Worker case ``tag`` against the single-device step (``single``,
    ``m``) at the fp32 rules above."""
    r = results[tag]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    want = _whole(single.params)
    got = {n: arrays[f"{tag}|params|{n}"] for n in want}
    assert not _masters_close(got, want, r["lr"], _whole(single.opt_state["m"]))
    assert not _grads_off(results, arrays, tag, single, m)


# worker case -> the single-device step it is held to (``_step``'s arguments)
SSM_SPLIT_CASES = {"mamba2-2.7b/float32/6heads": dict(name="mamba2-2.7b", heads=6),
                   "hymba-1.5b/float32/1x8": dict(name="hymba-1.5b")}


@pytest.mark.parametrize("tag", SSM_SPLIT_CASES)
def test_ssm_mixer_where_heads_do_not_split_like_attention(ranks, tag):
    """mamba2-2.7b with 6 SSM heads on 2x4 (6 do not divide the 4-way axis:
    the mixer gathered whole, though out_proj and ssm_norm are sharded);
    hymba-1.5b on 1x8 (the mixer head parallel, one head a rank, beside
    attention computed whole: the fused mixers' share of it 1/8 a rank)."""
    results, arrays = ranks
    _fp32_case(results, arrays, tag, *_step(dtype="float32", **SSM_SPLIT_CASES[tag]))


# tag -> (model axis, SSM heads): the mixer is head parallel exactly where
# the heads divide the axis (Block.plan_mesh; out_proj and ssm_norm are
# sharded over "model" in every case here)
MIXER_CASES = {"mamba2-2.7b/float32": (4, 8), "mamba2-2.7b/bfloat16": (4, 8),
               "mamba2-2.7b/float32/seq": (4, 8), "mamba2-2.7b/float32/remat": (4, 8),
               "hymba-1.5b/float32": (4, 8), "hymba-1.5b/bfloat16": (4, 8),
               "hymba-1.5b/float32/seq": (4, 8), "hymba-1.5b/float32/remat": (4, 8),
               "hymba-1.5b/float32/1x8": (8, 8), "mamba2-2.7b/float32/6heads": (4, 6)}


@pytest.mark.parametrize("tag", MIXER_CASES)
def test_ssm_mixer_is_head_parallel_where_heads_divide(ranks, tag):
    """``Block.ssm_tp`` as ``plan_mesh`` says it, and the shapes each rank
    computes with: one in_proj product over [z_r | x_r | B | C | dt_r]
    (2 x heads/M x hp + 2 N + heads/M columns), the scan on heads/M heads,
    out_proj's heads/M x hp rows; or, where the heads do not divide, the
    whole mixer."""
    results, _ = ranks
    M, nh = MIXER_CASES[tag]
    arch = _arch(tag.split("/")[0])
    hp, N, H = arch.ssm_headdim, arch.ssm_state, arch.d_model
    mixer = results[tag]["mixer"]
    tp = nh % M == 0
    assert mixer["ssm_tp"] == [tp] * arch.num_layers
    local = nh // M if tp else nh
    assert mixer["in_proj"] == [[H, 2 * local * hp + 2 * N + local]] * arch.num_layers
    assert mixer["out_proj"] == [[local * hp, H]] * arch.num_layers
    assert mixer["scan"] == [[2, 8, local, hp]] * arch.num_layers
    assert tp == (tag != "mamba2-2.7b/float32/6heads")


@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_sharded_gated_norm_matches_whole_rows(ranks, dtype):
    """``layers.rmsnorm_sharded`` over the 4-way model axis (64 of 256
    columns a rank, the squares summed across ranks) and its gradients in
    x and w (the sum's backward summing across ranks too) against
    ``kernels.ref.rmsnorm_ref`` of the whole rows and autograd through
    it: fp32 within 1e-5 relative and 1e-6 absolute (another summation
    order), fp64 within 1e-12."""
    from repro_torch.kernels.ref import rmsnorm_ref
    _, arrays = ranks
    x, w, cot = (torch.from_numpy(a).requires_grad_() for a in _norm_inputs(dtype))
    out = rmsnorm_ref(x, w)
    (out * cot).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-12, atol=1e-12)
    for key, want in (("out", out), ("dx", x.grad), ("dw", w.grad)):
        np.testing.assert_allclose(arrays[f"norm/{dtype}|{key}"], want.detach().numpy(),
                                   err_msg=key, **tol)


def test_sharded_mamba2_step_matches_the_reference(ranks, reference):
    """The port's sharded fp32 mamba2-2.7b step on 2x4 (the mixer head
    parallel) against the reference's partitioned step on a 2x4 mesh of 8
    host devices, from the same fan-in-H weights and batch: loss 1e-5,
    grad norm 1e-3, masters 1e-6 (2 lr where the reference's first moment
    says the step turned on the gradient's last digits), each leaf's
    gradient (from the first moments) within 1e-4 relative L2."""
    from repro_torch.convert import tree_path
    results, arrays = ranks
    name, tag = "mamba2-2.7b", "mamba2-2.7b/float32"
    r = results[tag]
    metric = lambda k: float(reference[f"{name}|metric|{k}"])
    assert r["loss"] == pytest.approx(metric("loss"), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(metric("grad_norm"), rel=1e-3)
    lr = metric("lr")
    names = [k.split("|", 2)[2] for k in arrays if k.startswith(f"{tag}|params|")]
    off = {}
    for n in names:
        path, layer = tree_path(n)
        key = "/".join(path)
        w, mom = reference[f"{name}|params|{key}"], reference[f"{name}|m|{key}"]
        if layer is not None:
            w, mom = w[layer], mom[layer]
        near = np.abs(mom) / 0.1 < 1e-6
        assert (np.abs(arrays[f"{tag}|params|{n}"] - w) <= np.where(near, 2 * lr, 1e-6)).all(), n
        got = _grads_of({n: arrays[f"{tag}|m|{n}"]}, r["grad_norm"])[n]
        off[n] = _rel(got, _grads_of({n: mom}, metric("grad_norm"))[n])
    worst = max(off, key=off.get)
    print(f"{tag} against the reference's mesh step: gradient, worst leaf {worst} "
          f"{off[worst]:.3g}")
    assert off[worst] <= 1e-4


def test_heads_that_do_not_divide_the_model_axis(ranks):
    """1x8: tiny yi-6b's 4 q heads on an 8-way axis, attention gathered whole."""
    results, arrays = ranks
    single, m = _step("yi-6b", "float32")
    r = results["yi-6b/float32/1x8"]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    want = _whole(single.params)
    got = {n: arrays[f"yi-6b/float32/1x8|params|{n}"] for n in want}
    assert not _masters_close(got, want, r["lr"], _whole(single.opt_state["m"]))
    assert not _grads_off(results, arrays, "yi-6b/float32/1x8", single, m)


def test_multi_pod_mesh(ranks, jax_yi):
    """A (2, 2, 2) ("pod", "data", "model") mesh: the batch over (pod, data),
    the weights replicated over pods."""
    results, arrays = ranks
    single, m = _single("yi-6b/float32", jax_yi)
    r = results["yi-6b/float32/2x2x2"]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    want = _whole(single.params)
    got = {n: arrays[f"yi-6b/float32/2x2x2|params|{n}"] for n in want}
    assert not _masters_close(got, want, r["lr"], _whole(single.opt_state["m"]))
    assert not _grads_off(results, arrays, "yi-6b/float32/2x2x2", single, m)


def test_elastic_reshard_is_exact(ranks):
    results, _ = ranks
    assert results["reshard_max_diff"] == 0.0
    assert results["reshard_placements"] == []


def test_checkpoint_crosses_meshes_bit_exactly(ranks):
    results, _ = ranks
    assert results["ckpt_extra"] == {"data_step": 1}
    assert results["ckpt_equal"]
    assert results["ckpt_placements"] == []


def test_prefill_and_eval_on_a_mesh(ranks):
    from repro_torch.models.lm import RunCfg, init_params, loss_fn
    from repro_torch.serving.serve import make_prefill_step
    results, arrays = ranks
    arch = _arch("yi-6b")
    model = init_params(arch, torch.Generator().manual_seed(5), RunCfg(torch.float32), "cpu")
    tokens = np.random.default_rng(0).integers(0, arch.vocab, (4, 12))
    want = make_prefill_step(model)({"tokens": tokens}).numpy()
    np.testing.assert_allclose(arrays["prefill"], want, rtol=1e-4, atol=1e-4)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(arch).items()}
    with torch.no_grad():
        loss = float(loss_fn(model, batch)[0])
    assert results["eval_loss"] == pytest.approx(loss, rel=1e-5)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
