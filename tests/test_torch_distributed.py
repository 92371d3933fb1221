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
weights; ``seq_shard`` and remat (recompute in the backward) for yi-6b
and hymba-1.5b; yi-6b on a 1x8 mesh, where its 4 heads do not divide the
model axis (attention gathered whole), and on a (2, 2, 2) ("pod", "data",
"model") mesh;
``elastic_reshard`` and a checkpoint from 2x4 onto a 2x2 mesh of ranks
0-3; prefill and the eval step on 2x4. The MoE archs on a mesh are
tests/test_torch_moe_mesh.py's.
On 2x4 tiny yi-6b's 2 kv heads do not divide the 4-way model axis: its
kv projections are gathered and each rank takes its q head's kv head.

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

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
ARCHS = ("yi-6b", "mamba2-2.7b", "hymba-1.5b", "hubert-xlarge")
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


def _arch(name):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    return scale_arch(get_config(name), "tiny")


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


def _state(name, dtype, mesh=None, params=None, seq_shard=False, fan_in_h=None):
    """A train state of tiny ``name``: the port's init (seed 9), rescaled to
    fan-in H where ``fan_in_h`` (default: the archs of ``FAN_IN_H``, and
    every arch in bf16), or the reference's tree ``params``."""
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train.step import init_train_state
    from repro_torch.parallel.comm import local
    from repro_torch.train.step import sync_model
    arch = _arch(name)
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


def _step(name, dtype, mesh=None, params=None, seq_shard=False, remat=False, fan_in_h=None):
    """(state after one G=2 step, metrics)."""
    from repro_torch.train.step import make_train_step
    arch, state = _state(name, dtype, mesh, params, seq_shard, fan_in_h)
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
    state, m = _step("hymba-1.5b", "float32", mesh, seq_shard=True)
    keep("hymba-1.5b/float32/seq", m, state)
    # remat: each Block's gathers and Megatron collectives run again in the
    # backward's recompute
    state, m = _step("yi-6b", "float32", mesh, params=tree, remat=True)
    keep("yi-6b/float32/remat", m, state)
    state, m = _step("hymba-1.5b", "float32", mesh, remat=True)
    keep("hymba-1.5b/float32/remat", m, state)
    state, m = _step("yi-6b", "float32", make_mesh((1, WORLD), ("data", "model"), "cpu"))
    keep("yi-6b/float32/1x8", m, state)
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
def ranks(tmp_path_factory, jax_yi):
    """Run the 8 workers; (results, arrays) of rank 0."""
    tmp = tmp_path_factory.mktemp("dist")
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


@pytest.mark.parametrize("name", ["yi-6b", "hymba-1.5b"])
def test_seq_shard_gives_the_same_loss(ranks, jax_yi, name):
    results, arrays = ranks
    off, on = results[f"{name}/float32"], results[f"{name}/float32/seq"]
    assert on["loss"] == pytest.approx(off["loss"], rel=1e-5)
    assert on["grad_norm"] == pytest.approx(off["grad_norm"], rel=1e-5)
    single, m = _single(f"{name}/float32", jax_yi)
    assert not _grads_off(results, arrays, f"{name}/float32/seq", single, m)


@pytest.mark.parametrize("name", ["yi-6b", "hymba-1.5b"])
def test_sharded_step_with_remat(ranks, jax_yi, name):
    """Remat on (``RunCfg.remat``'s default): each Block's weight gathers,
    Megatron collectives and, for hymba, the fused mixers' entry and exit
    run again in the backward's recompute. Held to the fp32 rules above
    against the single-device step with remat off."""
    results, arrays = ranks
    tag = f"{name}/float32/remat"
    single, m = _single(f"{name}/float32", jax_yi)
    r = results[tag]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    want = _whole(single.params)
    got = {n: arrays[f"{tag}|params|{n}"] for n in want}
    assert not _masters_close(got, want, r["lr"], _whole(single.opt_state["m"]))
    assert not _grads_off(results, arrays, tag, single, m)


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
