"""What the benchmark may import: nothing under ``benchmark/`` imports JAX
or the JAX package, and the reference imports nothing of the port; the
names are compared whole (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import core

FILES = sorted(p for p in core.BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    assert FILES
    for path in FILES:
        bad = top_level_imports(path) & set(core.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    ref = [p for p in FILES if "reference" in p.parts]
    assert len(ref) > 10
    for path in ref:
        assert core.PROGRAM not in top_level_imports(path), path


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, %r); import importlib, pkgutil; "
            "import benchmark.reference as r; "
            "[importlib.import_module('benchmark.reference.' + m.name) "
            "for m in pkgutil.walk_packages(r.__path__)]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'deformationpyramid_tpu', "
            "'deformationpyramid_tpu_torch'}))" % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_whole_name_comparison():
    import types
    sys.modules["deformationpyramid_tpu_torch_probe"] = types.ModuleType("x")
    try:
        assert "deformationpyramid_tpu" not in core.forbidden_modules()
    finally:
        del sys.modules["deformationpyramid_tpu_torch_probe"]
