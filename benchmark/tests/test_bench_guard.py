"""No module the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole."""

import ast

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import ROOT


def top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            names.add(node.module.split(".")[0])
    return names


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules({"snuffy_tpu_torch": 1,
                              "snuffy_tpu_torch.ops": 1, "torch": 1}) == []
    assert forbidden_modules({"snuffy_tpu.ops.x": 1}) == ["snuffy_tpu"]
    assert forbidden_modules({"jax._src": 1, "flax": 1, "jaxlib": 1}) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_modules({"jaxtyping": 1, "flaxen": 1}) == []


def test_no_harness_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for path in files:
        assert not (top_imports(path) & set(FORBIDDEN)), path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").rglob("*.py")):
        names = top_imports(path)
        assert "snuffy_tpu_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "torch",
                         "benchmark"}, (path, names)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), path
