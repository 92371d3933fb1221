"""The reference's runs on a 2x4 ("data", "model") mesh of 8 host devices,
for the port's mesh tests (pytest does not collect this module; it runs
as a script in a subprocess, so the 8-device ``XLA_FLAGS`` never reach
the test process, as in tests/test_distributed.py):

    python tests/torch_mesh_reference.py DIR CASE [CASE ...]

Each case reads its inputs from ``DIR/<case>_in.npz`` where it has some
and writes ``DIR/<case>.npz``:

* ``serve``: tiny granite-moe-3b-a800m from ``PRNGKey(0)`` at the default
  capacity, fp32: its tree, ``greedy_generate(mesh=)``'s tokens and the
  logits of ``make_serve_step(...).jit_with`` over fixed tokens;
* ``moe_ep``: ``layers.moe_ep`` on inputs from the in-file, its output,
  aux and ``jax.grad`` of sum(out * cot) in x and every weight;
* ``pipeline``: ``pipeline_apply`` at S 4, G 6 on a 4-device "pod" axis,
  and ``jax.grad`` of the sum of its squared outputs; ``compressed_psum``
  on an 8-device axis, ``quantize_int8`` and ``ef_compress_tree``;
* ``train``: one ``make_train_step(...).jit_with`` step for each tree in
  the in-file (granite-moe and dbrx-132b from tests/test_torch_moe_mesh.py,
  mamba2-2.7b from tests/test_torch_distributed.py), G = 2, fp32, the
  default capacity: the masters and first moments after the step, and the
  metrics.
"""

import os
import sys
from pathlib import Path

import numpy as np

from torch_mesh_common import flatten, unflatten

SERVE_PROMPT = (4, 6)       # greedy_generate: prompt [B, S0], then MAX_NEW tokens
MAX_NEW = 6
SERVE_STEPS = (4, 8)        # serve-step logits over fixed tokens [B, steps]
LR = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)


def serve_tokens(vocab):
    rng = np.random.default_rng(5)
    return (rng.integers(0, vocab, SERVE_PROMPT).astype(np.int32),
            rng.integers(0, vocab, SERVE_STEPS).astype(np.int32))


def _mesh(jax, shape, names):
    try:
        from jax.sharding import AxisType
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))
    except ImportError:
        return jax.make_mesh(shape, names)


def _serve(jax, jnp, mesh, out):
    from repro.configs import get_config
    from repro.launch.train import scale_arch
    from repro.models import lm as jlm
    from repro.serving import serve as jserve
    arch = scale_arch(get_config("granite-moe-3b-a800m"), "tiny")
    cfg = jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=jnp.float32)
    params = jlm.init_params(arch, jax.random.PRNGKey(0), jlm.RunCfg())
    prompt, steps = serve_tokens(arch.vocab)
    out.update({f"tree/{k}": v for k, v in flatten(params).items()})
    out["tokens"] = np.asarray(jserve.greedy_generate(arch, params, jnp.asarray(prompt), MAX_NEW,
                                                      cfg=cfg, mesh=mesh))
    B, n = steps.shape
    cache = jlm.init_cache(arch, B, n, cfg)
    shapes = lambda tree: jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
    step = jserve.make_serve_step(arch, cfg, mesh).jit_with(shapes(params), shapes(cache), B)
    logits = []
    for pos in range(n):
        _, lg, cache = step(params, cache, jnp.asarray(steps[:, pos]), jnp.int32(pos))
        logits.append(np.asarray(lg))
    out["logits"] = np.stack(logits)


def _moe_ep(jax, jnp, mesh, inp, out):
    from repro.models.layers import moe_ep
    params = {k: jnp.asarray(inp[k]) for k in ("router", "wg", "wi", "wo")}
    x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
    k, cf = int(inp["top_k"]), float(inp["capacity_factor"])
    f = jax.jit(lambda x, p: moe_ep(x, p, k, mesh, capacity_factor=cf))
    y, aux = f(x, params)
    out.update(out=np.asarray(y), load=np.asarray(aux["load"]),
               drop=np.asarray(aux["drop_fraction"]))
    gx, gp = jax.jit(jax.grad(lambda x, p: (f(x, p)[0] * cot).sum(), argnums=(0, 1)))(x, params)
    out["grad/x"] = np.asarray(gx)
    out.update({f"grad/{n}": np.asarray(g) for n, g in gp.items()})


def _pipeline(jax, jnp, out):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compression import compressed_psum, ef_compress_tree, quantize_int8
    from repro.parallel.pipeline import pipeline_apply
    S, G, B, H = 4, 6, 2, 16
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((S, H, H)) / np.sqrt(H)).astype(np.float32)
    mbs = rng.standard_normal((G, B, H)).astype(np.float32)
    stage_mesh = _mesh(jax, (S,), ("pod",))
    stage_fn = lambda w, x: jnp.tanh(x @ w)
    out.update(w=w, mbs=mbs)
    out["piped"] = np.asarray(pipeline_apply(stage_fn, jnp.asarray(w), jnp.asarray(mbs),
                                             stage_mesh, axis="pod"))
    loss = lambda w: jnp.sum(pipeline_apply(stage_fn, w, jnp.asarray(mbs), stage_mesh,
                                            axis="pod") ** 2)
    out["pipe_grad"] = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    pods = _mesh(jax, (8,), ("pod",))
    x = rng.standard_normal((8, 700)).astype(np.float32)     # a partial block at the end
    out["psum_in"] = x
    out["psum"] = np.asarray(shard_map(lambda v: compressed_psum(v, "pod"), mesh=pods,
                                       in_specs=P("pod"), out_specs=P("pod"))(jnp.asarray(x)))
    g = rng.standard_normal((3, 300)).astype(np.float32)
    q, s = quantize_int8(jnp.asarray(g))
    out.update(q_in=g, q=np.asarray(q), q_scale=np.asarray(s))
    grads = {"a": jnp.asarray(g), "b": {"c": jnp.asarray(x[:2])}}
    comp, ef = ef_compress_tree(grads, None)
    comp2, ef2 = ef_compress_tree(grads, ef)
    for tag, tree in (("comp", comp), ("ef", ef), ("comp2", comp2), ("ef2", ef2)):
        out.update({f"{tag}/{k}": v for k, v in flatten(tree).items()})


def _train(jax, jnp, mesh, inp, out):
    from repro.configs import get_config
    from repro.launch.train import scale_arch
    from repro.models import lm as jlm
    from repro.train import optim as joptim
    from repro.train import step as jstep
    cfg = jstep.TrainCfg(run=jlm.RunCfg(q_chunk=0, remat=False, compute_dtype=jnp.float32),
                         opt=joptim.OptimizerCfg(**LR), num_microbatches=2)
    for name in sorted({k.split("|", 1)[0] for k in inp if "|tree|" in k}):
        arch = scale_arch(get_config(name), "tiny")
        params = jax.tree.map(jnp.asarray, unflatten(
            {k.split("|", 2)[2]: v for k, v in inp.items() if k.startswith(f"{name}|tree|")}))
        batch = {k: jnp.asarray(inp[f"{name}|batch|{k}"]) for k in ("tokens", "labels")}
        opt = joptim.init_opt_state(cfg.opt, params)
        shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
        step = jstep.make_train_step(arch, cfg, mesh).jit_with(shapes, batch)
        new, opt, metrics = step(params, opt, batch)
        for tag, tree in (("params", new), ("m", opt["m"])):
            out.update({f"{name}|{tag}|{k}": v
                        for k, v in flatten(jax.tree.map(np.asarray, tree)).items()})
        out.update({f"{name}|metric|{k}": np.asarray(v) for k, v in metrics.items()})


def main(tmp: Path, cases) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    mesh = _mesh(jax, (2, 4), ("data", "model"))
    for case in cases:
        out = {}
        inp = dict(np.load(tmp / f"{case}_in.npz")) if (tmp / f"{case}_in.npz").exists() else {}
        if case == "serve":
            _serve(jax, jnp, mesh, out)
        elif case == "moe_ep":
            _moe_ep(jax, jnp, mesh, inp, out)
        elif case == "pipeline":
            _pipeline(jax, jnp, out)
        elif case == "train":
            _train(jax, jnp, mesh, inp, out)
        else:
            raise ValueError(f"unknown case {case!r}")
        np.savez(tmp / f"{case}.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2:])
