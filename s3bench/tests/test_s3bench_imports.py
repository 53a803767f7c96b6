"""No run imports JAX or the JAX package, and the reference imports
nothing of the program either."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import harness

S3BENCH = harness.HERE


def _names(nodes) -> set:
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _imports(path: Path) -> set:
    return _names(ast.walk(ast.parse(path.read_text())))


def _module_level_imports(path: Path) -> set:
    """The imports of ``path`` outside any function's body."""
    def walk(node):
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                yield from walk(child)
    return _names(walk(ast.parse(path.read_text())))


def test_reference_imports_neither_jax_nor_the_program():
    paths = sorted((S3BENCH / "ref").rglob("*.py"))
    assert S3BENCH / "ref/shapes/cube.py" in paths
    for path in paths:
        got = _imports(path)
        assert not got & {"jax", "jaxlib", "flax",
                          "sparsespatialsampling_tpu",
                          "sparsespatialsampling_torch"}, (path, got)


def test_geometry_kinds_import_the_program_inside_make():
    """The program's geometry kinds import it where they make an object,
    never when they are loaded."""
    paths = sorted((S3BENCH / "geometry").glob("*.py"))
    assert S3BENCH / "geometry/cube.py" in paths
    for path in paths:
        assert "sparsespatialsampling_torch" in _imports(path), path
        got = _module_level_imports(path)
        assert not got & {"sparsespatialsampling_torch",
                          "sparsespatialsampling_tpu"}, (path, got)


def test_no_file_of_the_benchmark_imports_jax():
    for path in sorted(S3BENCH.rglob("*.py")):
        got = _imports(path)
        assert not got & {"jax", "jaxlib", "flax",
                          "sparsespatialsampling_tpu"}, (path, got)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparsespatialsampling_torch_x",
                        sys.modules["json"])
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_run_loads_no_jax_module(tmp_path):
    """A job and its check, in a fresh process, leave no module of JAX or
    of the JAX package loaded; the reference alone loads nothing of the
    program."""
    code = f"""
import sys, json
sys.path[:0] = [{str(S3BENCH)!r}, {str(S3BENCH.parent)!r},
                {str(S3BENCH / 'tests')!r}]
from pathlib import Path
import ref.compare, ref.s3, ref.knn
alone = sorted(m for m in sys.modules
               if m.split('.')[0].startswith('sparsespatialsampling'))
import conftest, harness
root = conftest.tiny_root(Path({str(tmp_path)!r}) / 'bench')
cell = harness.Cell('t2.sweep', root)
inputs = cell.inputs(3, 0, 'cpu')
rec = harness.run_job(cell, inputs, 'cpu', root / 'out', keep=True)
harness.check(cell, inputs, rec['grids'], 'cpu')
print(json.dumps({{"alone": alone, "after": harness.forbidden_modules(),
                  "port": 'sparsespatialsampling_torch' in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"alone": [], "after": [], "port": True}


def test_run_refuses_without_a_card(tmp_path):
    """Here (no card) the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(S3BENCH / "run.py"),
                          "--workload", "oat15.cold", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=S3BENCH.parent)
    assert out.returncode != 0
    assert not out.stdout.strip()
