"""Import hygiene of the PyTorch port: nothing under ``src/repro_torch/``,
in ``examples/torch_*.py`` or in ``chip_smoke.py`` imports JAX or the JAX
package, no kernel wrapper can swallow a failed launch into a fallback, and
every module of the JAX package has its counterpart in the port."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REFERENCE = ROOT / "src" / "repro"
FORBIDDEN = ("jax", "jaxlib", "repro")
# The one module whose port has another name: the reference's cost model
# reads XLA's HLO, the port's counts the ops of a traced step.
RENAMED = {"launch/hlo_cost.py": "launch/op_cost.py"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) \
                == "import_module" and node.args \
                and isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values if isinstance(v, ast.Constant))
            yield node.lineno, text


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*")}
    for want in ("kernels/flash_attention.py", "kernels/ops.py", "kernels/ref.py",
                 "csrc/flash_attention.cu", "launch/serve.py", "convert.py",
                 "kernels/rglru.py", "csrc/rglru.cu", "nn/recurrent.py", "nn/moe.py",
                 "core/platform.py", "core/guardian.py", "api/gateway.py",
                 "api/http.py", "api/cli.py", "analysis/__main__.py",
                 "analysis/baseline.json"):
        assert want in names
    assert (ROOT / "chip_smoke.py").exists()


def test_every_reference_module_has_its_port():
    """Each ``*.py`` of the JAX package has its counterpart at the same path
    in the port, ``RENAMED`` its one documented exception; and each of the
    reference's examples has its ``examples/torch_*.py``."""
    missing = []
    for path in sorted(REFERENCE.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(REFERENCE).as_posix()
        if not (PORT / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []
    assert all(not (PORT / rel).exists() and (REFERENCE / rel).is_file() for rel in RENAMED)
    for example in sorted((ROOT / "examples").glob("*.py")):
        if not example.name.startswith("torch_"):
            assert (example.parent / f"torch_{example.name}").is_file(), example.name


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_kernel_wrappers_have_no_exception_fallback():
    """A CUDA tensor reaches the kernel or raises: no except clause in the
    kernels package or in chip_smoke.py."""
    for path in sorted((PORT / "kernels").glob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        handlers = [n.lineno for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{path}: except clauses at lines {handlers}"
