"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's (``repro.parallel.sharding``) for every arch of the zoo at
full scale, on the meshes the reference launches: (2, 4) as its
distributed test, the (16, 16) production pod and the (2, 16, 16)
multi-pod mesh. JAX's specs come from ``jax.eval_shape`` of its
``init_params`` / ``init_cache`` on an ``AbstractMesh`` (no devices); the
port's from its ``LM`` on the meta device and axis sizes alone. A
per-layer leaf's spec is the reference's stacked leaf's without its
leading (layer) entry."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import LM, RunCfg  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(name, mesh) for name in sorted(jax_configs.ARCHS) for mesh in MESHES]


def _meshes(mesh):
    shape, names = MESHES[mesh]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _ref_param_specs(name, jmesh):
    """{port parameter name: the reference's spec as a tuple}."""
    arch = jax_configs.get_config(name)
    shapes = jax.eval_shape(lambda: jlm.init_params(arch, jax.random.PRNGKey(0), jlm.RunCfg()))
    specs = dict(_flat(jsharding.param_pspecs(shapes, jmesh)))
    out = {}
    for path, spec in specs.items():
        if path[0] == "layers":
            assert spec[0] is None, (path, spec)
            for i in range(arch.num_layers):
                out[".".join(("blocks", str(i), *path[1:]))] = tuple(spec)[1:]
        else:
            out[".".join(path)] = tuple(spec)
    return out


@pytest.mark.parametrize("name,mesh", CASES)
def test_param_specs_equal_reference(name, mesh):
    jmesh, axes = _meshes(mesh)
    model = LM(get_config(name), RunCfg(), device="meta")
    got = sharding.param_pspecs(model, axes)
    want = _ref_param_specs(name, jmesh)
    assert sorted(got) == sorted(want)
    assert {n: got[n] for n in got if got[n] != want[n]} == {}
    # the placements the planner gives are the specs' (one sharded leaf checked)
    names = MESHES[mesh][1]
    for n, spec in got.items():
        pl = sharding.placements_of(spec, names)
        for dim, entry in enumerate(spec):
            for axis in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                assert pl[names.index(axis)].is_shard(dim), (n, spec, pl)


@pytest.mark.parametrize("name,mesh", CASES)
def test_cache_specs_equal_reference(name, mesh):
    """Decode caches at B = 8 and at B = 1 (the batch-1 fallback)."""
    jmesh, axes = _meshes(mesh)
    jarch, arch = jax_configs.get_config(name), get_config(name)
    model = LM(arch, RunCfg(), device="meta")
    for batch in (1, 8):
        jcache = jax.eval_shape(lambda: jlm.init_cache(jarch, batch, 4096, jlm.RunCfg()))
        cache = model.init_cache(batch, 4096)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: tuple(v.shape) for k, v in jcache.items()}
        want = {k: tuple(v) for k, v in jsharding.cache_pspecs(jarch, jcache, jmesh).items()}
        assert sharding.cache_pspecs(arch, cache, axes) == want


@pytest.mark.parametrize("name,mesh", CASES)
def test_batch_specs_equal_reference(name, mesh):
    """The batch leaves of ``name`` (tokens/labels [G,B,S], embeds [G,B,S,H])
    with and without the leading microbatch dim, at batch sizes that divide
    the batch axes and that do not."""
    jmesh, axes = _meshes(mesh)
    arch = get_config(name)
    for lead in (False, True):
        assert sharding.batch_pspec(axes, lead) == tuple(jsharding.batch_pspec(jmesh, lead))
        for B in (1, 4, 8, 32, 64):
            shapes = [(B, 128)] + ([(B, 128, arch.d_model)] if arch.embeds_input else [])
            for shape in shapes:
                shape = (2, *shape) if lead else shape
                want = jsharding.fit_first([jsharding.batch_pspec(jmesh, lead)], shape, jmesh)
                got = sharding.fit_first([sharding.batch_pspec(axes, lead)], shape, axes)
                assert got == tuple(want), (lead, shape)


def test_rules_are_a_copy():
    """The reference's candidate chains, leaf by leaf, equal the port's."""
    paths = [("embed",), ("lm_head",), ("final_norm",), ("layers", "norm1"),
             ("layers", "norm2")] + [("layers", g, n) for g, names in {
                 "attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wg", "wo"),
                 "moe": ("router", "wi", "wg", "wo"),
                 "ssm": ("in_proj", "out_proj", "conv_w", "conv_b", "ssm_norm", "A_log", "D",
                         "dt_bias")}.items() for n in names] + [("layers", "x", "other")]
    for path in paths:
        for ndim in (1, 2, 3, 4):
            want = [tuple(c) for c in jsharding._leaf_candidates(path, ndim)]
            assert sharding._leaf_candidates(path, ndim) == want, path
    np.testing.assert_equal(sharding.FSDP, jsharding.FSDP)
    np.testing.assert_equal(sharding.TP, jsharding.TP)
