"""The port's sharded train step of the MoE archs (the expert-parallel
``layers.moe_ep`` over "model") on an 8-rank 2x4 ("data", "model") CPU
mesh (gloo): against the port's single-device step where no assignment
drops, and against the reference's own sharded step
(``make_train_step(...).jit_with`` on 8 host devices,
tests/torch_mesh_reference.py) at the default capacity, where the mesh
changes the answer (each rank sizes an expert's capacity from its own
tokens).

The workers run this file as a script (``_worker``; tests/torch_mesh_common.py).
Cases (tiny granite-moe-3b-a800m and dbrx-132b, G = 2 microbatches of
2 x 24 tokens, ``seed=3`` data, weights rescaled to fan-in H as
tests/torch_train_common.py's STEP_INIT has granite-moe): drop-free
(capacity factor 8) in fp32 and bf16, and in fp32 with ``seq_shard``
(the sequence gathered into the layer and the output reduce-scattered
back), with remat, and on a 1x8 mesh (the 4 experts padded to 8, one a
rank, the experts' weights gathered whole and cut: their placements put
d_ff, not E, over "model"); the default capacity 1.25 in fp32 from the
reference's init of ``PRNGKey(0)`` rescaled the same way. At tiny scale
the two archs have the same shapes (``scale_arch`` caps E at 4, top-k at
2) and differ only by name.

Bounds: the rules of tests/test_torch_distributed.py. fp32: loss 1e-5
relative, grad norm 1e-3, masters 1e-6 (2 lr where |clipped gradient| <
100 eps), each leaf's gradient within 1e-4 relative L2. bf16: the
sharded gradient no further from the single-device fp32 one than 1.25x
the single-device bf16 one (whole; 2.5x a leaf), each master's change
within 0.5 relative L2 of the single-device bf16 change, loss 1e-3 and
masters 5e-2; here with every expert taken (top-k = E), as
tests/torch_train_common.py holds bf16 MoE gradients: bf16 routing flips
near-ties, and the two sides round x differently before the router. The
reference's step: loss 1e-5, grad norm 1e-3, masters 1e-6 (2 lr where
its first moment says the step turned on the gradient's last digits).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_common import (Clock, flatten, init_rank, reference_runs, rel,  # noqa: E402
                               save, spawn_ranks, unflatten)

ARCHS = ("granite-moe-3b-a800m", "dbrx-132b")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LR = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
DROP_FREE = 8.0
MESHES = {"2x4": (2, 4), "1x8": (1, 8)}
# (tag suffix, dtype, seq_shard, remat, mesh)
VARIANTS = [("float32", "float32", False, False, "2x4"),
            ("bfloat16", "bfloat16", False, False, "2x4"),
            ("float32/seq", "float32", True, False, "2x4"),
            ("float32/remat", "float32", False, True, "2x4"),
            ("float32/1x8", "float32", False, False, "1x8")]


def _arch(name, all_experts=False):
    """Tiny ``name``; with ``all_experts``, top-k = E."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    arch = scale_arch(get_config(name), "tiny")
    return dataclasses.replace(arch, top_k=arch.n_experts) if all_experts else arch


def _batch(arch):
    from repro_torch.train.data import DataCfg, SyntheticDataset
    return SyntheticDataset(arch, DataCfg(seq_len=24, global_batch=4, num_microbatches=2,
                                          seed=3)).batch_at(0)


def _cfg(dtype, seq_shard=False, remat=False, cf=DROP_FREE):
    from repro_torch.models.lm import RunCfg
    from repro_torch.train import optim
    from repro_torch.train.step import TrainCfg
    run = RunCfg(compute_dtype=DTYPES[dtype], remat=remat, seq_shard=seq_shard,
                 capacity_factor=cf)
    return TrainCfg(run=run, opt=optim.OptimizerCfg(**LR), num_microbatches=2)


def fan_in_h(tree, arch):
    """The experts' wi and wg and the attention's wq, wk, wv from std
    (1/L)^0.5 to (1/H)^0.5 (tests/torch_train_common.py's ``_fan_in_h``)."""
    f = (arch.num_layers / arch.d_model) ** 0.5
    layers = {g: {k: v * f if k in ("wq", "wk", "wv", "wi", "wg") else v for k, v in p.items()}
              if isinstance(p, dict) else p for g, p in tree["layers"].items()}
    return dict(tree, layers=layers)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def start_state(arch, cfg, mesh=None, tree=None):
    """A train state before its step: the port's init (seed 9), or ``tree``
    (the reference's), rescaled to fan-in H, fresh moments."""
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.train.step import init_train_state
    state = init_train_state(arch, cfg, torch.Generator().manual_seed(9), "cpu", mesh=mesh)
    start = fan_in_h(train_state_to_numpy(state)["params"] if tree is None else tree, arch)
    train_state_from_numpy(state, {"params": start, "opt_state": {
        "m": _zeros(start), "v": _zeros(start), "step": np.int32(0)}})
    return state


def run_step(name, dtype, mesh=None, seq_shard=False, remat=False, cf=DROP_FREE, tree=None,
             all_experts=None):
    """One G=2 step from ``start_state``: (state, metrics). bf16 takes every
    expert unless ``all_experts`` says otherwise."""
    from repro_torch.train.step import make_train_step
    arch = _arch(name, dtype == "bfloat16" if all_experts is None else all_experts)
    cfg = _cfg(dtype, seq_shard, remat, cf)
    return make_train_step(arch, cfg, mesh)(start_state(arch, cfg, mesh, tree), _batch(arch))


def whole(named):
    """{name: fp32 numpy}, DTensors gathered (every rank of the mesh calls it)."""
    from repro_torch.parallel.comm import is_dtensor
    return {n: (t.detach().full_tensor() if is_dtensor(t) else t.detach()).float().numpy()
            for n, t in named.items()}


# ---------------------------------------------------------------------------
# the worker (a subprocess of this file run as a script; no JAX)
# ---------------------------------------------------------------------------

def _worker(rank: int, tmp: Path) -> None:
    from repro_torch.launch.mesh import make_mesh
    init_rank(rank, tmp)
    meshes = {k: make_mesh(v, ("data", "model"), "cpu") for k, v in MESHES.items()}
    clock, results, arrays = Clock(), {}, {}

    def keep(tag, state, metrics):
        results[tag] = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr", "moe_drop")}
        arrays.update({f"{tag}|params|{n}": a for n, a in whole(state.params).items()})
        arrays.update({f"{tag}|m|{n}": a for n, a in whole(state.opt_state["m"]).items()})
        clock(tag)

    ref = dict(np.load(tmp / "train_in.npz"))
    for name in ARCHS:
        for suffix, dtype, seq, remat, mesh in VARIANTS:
            keep(f"{name}/{suffix}", *run_step(name, dtype, meshes[mesh], seq, remat))
        tree = unflatten({k.split("|", 2)[2]: v for k, v in ref.items()
                          if k.startswith(f"{name}|raw|")})
        keep(f"{name}/default", *run_step(name, "float32", meshes["2x4"], cf=1.25, tree=tree))
    save(rank, tmp, results, arrays)


# ---------------------------------------------------------------------------
# the tests (this process: the single-device port; the reference's mesh run)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's sharded steps, then the 8 workers: (results, arrays
    of rank 0, the reference's arrays)."""
    import jax
    from repro.configs import get_config
    from repro.launch.train import scale_arch
    from repro.models import lm as jlm
    tmp = tmp_path_factory.mktemp("moe_mesh")
    inp = {}
    for name in ARCHS:
        jarch = scale_arch(get_config(name), "tiny")
        tree = jax.tree.map(np.asarray, jlm.init_params(jarch, jax.random.PRNGKey(0),
                                                         jlm.RunCfg()))
        inp.update({f"{name}|raw|{k}": v for k, v in flatten(tree).items()})
        inp.update({f"{name}|tree|{k}": v for k, v in flatten(fan_in_h(tree, jarch)).items()})
        inp.update({f"{name}|batch|{k}": v for k, v in _batch(_arch(name)).items()})
    np.savez(tmp / "train_in.npz", **inp)
    ref = reference_runs(tmp, "train")["train"]
    results, arrays = spawn_ranks(__file__, tmp)
    return results, arrays, ref


def _grads_of(moments, grad_norm):
    """The step's gradient (the G=2 mean) from the first moments after one
    step: m = (1 - b1) x the gradient clipped to norm 1."""
    clip = min(1.0, 1.0 / (float(grad_norm) + 1e-9))
    return {n: a / (0.1 * clip) for n, a in moments.items()}


def _masters_off(got, want, lr, moments):
    """Leaves past 1e-6 (2 lr where |m| / (1 - b1) < 100 eps)."""
    return [n for n, w in want.items()
            if not (np.abs(got[n] - w) <= np.where(np.abs(moments[n]) / 0.1 < 1e-6, 2 * lr,
                                                  1e-6)).all()]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("suffix", [v[0] for v in VARIANTS if v[1] == "float32"])
def test_moe_sharded_step_matches_single_device_fp32(ranks, name, suffix):
    results, arrays, _ = ranks
    tag = f"{name}/{suffix}"
    state, m = run_step(name, "float32")
    r = results[tag]
    # drop-free: 1 - mean(keep) reads -3e-8 on one device (the reference's
    # fused form, fp32 reciprocal of T k times the count)
    assert abs(r["moe_drop"]) < 1e-6 and abs(float(m["moe_drop"])) < 1e-6
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
    want, moments = whole(state.params), whole(state.opt_state["m"])
    got = {n: arrays[f"{tag}|params|{n}"] for n in want}
    assert not _masters_off(got, want, r["lr"], moments)
    g = _grads_of({n: arrays[f"{tag}|m|{n}"] for n in want}, r["grad_norm"])
    g1 = _grads_of(moments, m["grad_norm"])
    off = {n: rel(g[n], g1[n]) for n in want}
    worst = max(off, key=off.get)
    print(f"{tag}: gradient, worst leaf {worst} {off[worst]:.3g}")
    assert off[worst] <= 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_moe_sharded_step_matches_single_device_bf16(ranks, name):
    results, arrays, _ = ranks
    tag = f"{name}/bfloat16"
    r = results[tag]
    arch = _arch(name, True)
    init = whole(start_state(arch, _cfg("bfloat16")).params)
    single, m = run_step(name, "bfloat16")
    fp32, m32 = run_step(name, "float32", all_experts=True)
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-3)
    after = whole(single.params)
    for n, w in after.items():
        assert np.abs(arrays[f"{tag}|params|{n}"] - w).max() < 5e-2, n
    g32 = _grads_of(whole(fp32.opt_state["m"]), m32["grad_norm"])
    g16 = _grads_of(whole(single.opt_state["m"]), m["grad_norm"])
    got = _grads_of({n: arrays[f"{tag}|m|{n}"] for n in g32}, r["grad_norm"])
    flat = lambda g: np.concatenate([g[n].ravel() for n in g32])
    ratio = rel(flat(got), flat(g32)) / rel(flat(g16), flat(g32))
    leaf = {n: rel(got[n], g32[n]) / rel(g16[n], g32[n]) for n in g32}
    moved = {n: rel(arrays[f"{tag}|params|{n}"] - init[n], after[n] - init[n]) for n in init}
    worst, most = max(leaf, key=leaf.get), max(moved, key=moved.get)
    print(f"{tag}: gradient from fp32 {ratio:.4g}x the single-device bf16's; worst leaf "
          f"{worst} {leaf[worst]:.4g}x; master change, worst leaf {most} {moved[most]:.3g}")
    assert ratio <= 1.25
    assert leaf[worst] <= 2.5
    assert moved[most] <= 0.5


@pytest.mark.parametrize("name", ARCHS)
def test_moe_sharded_step_matches_the_reference_at_default_capacity(ranks, name):
    from repro_torch.convert import tree_path
    results, arrays, ref = ranks
    tag = f"{name}/default"
    r = results[tag]
    metric = lambda k: float(ref[f"{name}|metric|{k}"])
    assert r["loss"] == pytest.approx(metric("loss"), rel=1e-5)
    assert r["grad_norm"] == pytest.approx(metric("grad_norm"), rel=1e-3)
    assert r["moe_drop"] == pytest.approx(metric("moe_drop"), abs=1e-6)
    assert metric("moe_drop") > 0
    lr = metric("lr")
    names = [k.split("|", 2)[2] for k in arrays if k.startswith(f"{tag}|params|")]
    for n in names:
        path, layer = tree_path(n)
        key = "/".join(path)
        w, mom = ref[f"{name}|params|{key}"], ref[f"{name}|m|{key}"]
        if layer is not None:
            w, mom = w[layer], mom[layer]
        near = np.abs(mom) / 0.1 < 1e-6
        got = arrays[f"{tag}|params|{n}"]
        assert (np.abs(got - w) <= np.where(near, 2 * lr, 1e-6)).all(), n


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
