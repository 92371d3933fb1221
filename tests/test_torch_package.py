"""Package rules of the port: its copies of the reference's config data
stay equal to the originals, it imports neither JAX nor ``repro``, and
its weight conversion round-trips exactly."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch.train import scale_arch as jax_scale_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import RunCfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("*.py")))


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.active_param_count() == b.active_param_count()
    assert (a.ssm_n_heads, a.has_attention, a.subquadratic, a.is_encoder_only) == \
        (b.ssm_n_heads, b.has_attention, b.subquadratic, b.is_encoder_only)


@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS) + sorted(jax_configs.PAPER_MODELS))
def test_config_copy_equals_reference(name):
    _same(configs.get_config(name), jax_configs.get_config(name))


def test_registries_and_shapes_equal_reference():
    assert sorted(configs.ARCHS) == sorted(jax_configs.ARCHS)
    assert sorted(configs.PAPER_MODELS) == sorted(jax_configs.PAPER_MODELS)
    assert configs.list_archs() == jax_configs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for name in configs.ARCHS:
        for shape in configs.SHAPES:
            assert configs.shape_applicable(configs.get_config(name), configs.SHAPES[shape]) == \
                jax_configs.shape_applicable(jax_configs.get_config(name),
                                             jax_configs.SHAPES[shape])


@pytest.mark.parametrize("scale", ["tiny", "small", "full"])
def test_scale_arch_equals_reference(scale):
    for name in jax_configs.ARCHS:
        _same(scale_arch(configs.get_config(name), scale),
              jax_scale_arch(jax_configs.get_config(name), scale))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving.serve, repro_torch.convert, repro_torch.core, "
            "repro_torch.core.fastbatch, repro_torch.fabric, repro_torch.fabric.model, "
            "repro_torch.obs, repro_torch.api, repro_torch.api.cli, repro_torch.core.planner, "
            "repro_torch.serving, repro_torch.serving.workload, repro_torch.serving.batcher, "
            "repro_torch.serving.system, repro_torch.serving.planner, repro_torch.__main__, "
            "repro_torch.search, repro_torch.search.engine; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         check=True).stdout
    assert out.strip() == "[]"


def _jax_tree(name="yi-6b"):
    arch = jax_scale_arch(jax_configs.get_config(name), "tiny")
    return jax.tree.map(np.asarray, jlm.init_params(arch, jax.random.PRNGKey(4), jlm.RunCfg()))


@pytest.mark.parametrize("name", ["yi-6b", "minitron-4b", "mamba2-2.7b", "hymba-1.5b",
                                  "granite-moe-3b-a800m"])
def test_params_round_trip_exactly(name):
    tree = _jax_tree(name)
    arch = scale_arch(configs.get_config(name), "tiny")
    back = params_to_numpy(params_from_numpy(tree, arch, RunCfg(torch.float32), device="cpu"))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    # in bf16 the first conversion rounds; converting again changes nothing
    bf = RunCfg(torch.bfloat16)
    once = params_to_numpy(params_from_numpy(tree, arch, bf, device="cpu"))
    twice = params_to_numpy(params_from_numpy(once, arch, bf, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(once), jax.tree_util.tree_leaves(twice)):
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_rejects_a_foreign_tree():
    tree = _jax_tree()
    arch = scale_arch(configs.get_config("yi-6b"), "tiny")
    missing = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "norm2"})
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, arch, device="cpu")
    wrong = dict(tree, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(wrong, arch, device="cpu")
