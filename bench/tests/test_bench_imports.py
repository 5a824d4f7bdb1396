"""What the benchmark's modules import and read: nothing of JAX or of the JAX
package (top-level names compared whole: ``repro_torch`` is not ``repro``),
nothing of ``benchmarks/``, and the reference nothing of the port."""

import ast

import pytest

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted((ROOT / "bench").rglob("*.py"))
# the reference and what it imports of the benchmark
REFERENCE_SIDE = {"reference/model.py", "reference/__init__.py", "weights.py", "flops.py",
                  "data.py"}


def imported(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module)
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package_nor_benchmarks(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if path.name == "test_bench_imports.py":
        return  # this file names what it looks for
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, str) and id(n) not in docs]
    assert not [s for s in strings if "benchmarks" in s.split("/")]


def test_the_reference_imports_nothing_of_the_port():
    for rel in REFERENCE_SIDE:
        names = imported(ROOT / "bench" / rel)
        assert not {n for n in names if n.split(".")[0] == "repro_torch"}, rel
        assert {n.split(".")[0] for n in names} <= {"__future__", "math", "zlib", "torch",
                                                    "numpy", "bench"}, rel
        assert {n for n in names if n.startswith("bench.")} <= {
            "bench.flops", "bench.weights"}, rel


def test_forbidden_modules_are_compared_by_whole_name():
    from bench import harness
    assert harness.loaded_forbidden(["repro_torch", "repro_torch.models.steps", "numpy"]) == []
    assert harness.loaded_forbidden(["repro.core.platform", "jax._src", "flax"]) == [
        "flax", "jax", "repro"]
