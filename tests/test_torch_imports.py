"""Import hygiene of the PyTorch port: nothing under ``src/repro_torch/``
and nothing in ``chip_smoke.py`` imports JAX or the JAX package, and no
kernel wrapper can swallow a failed launch into a fallback."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                 "kernels/rglru.py", "csrc/rglru.cu", "nn/recurrent.py", "nn/moe.py"):
        assert want in names
    assert (ROOT / "chip_smoke.py").exists()


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
