"""Nothing the benchmark loads is JAX, Flax or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), the
reference imports nothing of the port, and nothing reads ``benchmarks/``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
FOREIGN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_a_foreign_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FOREIGN, (path, tops & FOREIGN)
        assert "benchmarks/" not in path.read_text(), path


def test_the_reference_takes_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path
    for path in [HERE / "weights.py", HERE / "traffic.py", HERE / "sizes.py"] + list(
            (HERE / "flops").glob("*.py")):
        assert "repro_torch" not in {n.split(".")[0] for n in _imports(path)}, path


def test_loading_every_module_loads_no_foreign_package():
    """In a fresh interpreter: import every module of the benchmark and
    its metric readers, then list the top-level names loaded."""
    code = f"""
import json, sys, importlib
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench import spec
for p in sorted(__import__('pathlib').Path({str(HERE)!r}).rglob('*.py')):
    rel = p.relative_to({str(ROOT)!r})
    if 'tests' in rel.parts or p.name == 'run.py' or p.name == 'control.py':
        continue
    if rel.parts[1] == 'metrics' and p.name not in ('__init__.py', 'common.py'):
        spec.metric_reader(p.name[:-3])
    else:
        importlib.import_module('.'.join(rel.with_suffix('').parts).replace('.__init__', ''))
import portbench.faults, repro_torch.train.step, repro_torch.serving.serve
sys.argv = ['run.py']
spec.load_module(__import__('pathlib').Path({str(HERE / 'run.py')!r}), 'portbench_run')
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in loaded and "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
