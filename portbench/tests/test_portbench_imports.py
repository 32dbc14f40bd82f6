"""What the benchmark loads: nothing of the JAX stack or the JAX package
``repro`` where it runs, nothing of the program in the reference. Module
names are compared by their top-level name whole (``repro_torch`` is not
``repro``)."""
import ast
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(HERE, "reference")):
        bad = set(_imports(path)) & {"repro_torch", *FORBIDDEN}
        assert not bad, (path, bad)


def test_no_benchmark_source_names_the_jax_stack():
    for path in _sources(HERE):
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_a_run_loads_no_jax(tmp_path):
    """A whole smoke run, in a fresh interpreter, leaves no module of the
    JAX stack or the JAX package in ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]
from portbench import harness
from portbench.tests.smoke import smoke_tree
bench, here, cells = smoke_tree({str(tmp_path)!r})
harness.run_cell(bench, cells[2], 1, 0.0, False, "cpu", 0.0, here=here,
                 log=lambda s: None)
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED")]
    loaded = set(eval(line[-1][len("LOADED "):]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & set(FORBIDDEN)
