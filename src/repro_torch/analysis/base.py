"""Shared plumbing for the invariant analyzers: the port's copy of
``src/repro/analysis/base.py``. What changed: the default target is the
port's own package, ``src/repro_torch`` (``DEFAULT_TARGET``,
``load_sources``), and ``BASELINE_PATH`` is the port's own
``baseline.json``, beside this file.

Everything here is stdlib-only (``ast``, ``json``, ``pathlib``): the
analyzers must run in CI and in the bare container with no third-party
installs. A checker is a function ``(sources) -> list[Finding]`` over
pre-parsed :class:`SourceFile` objects; the CLI subtracts the committed
``baseline.json`` and exits non-zero on anything left.

Baseline keys deliberately omit line numbers — ``CHECK:path:scope:detail``
— so unrelated edits above a justified exception don't invalidate it,
while moving the offending code to a *different* function does.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

#: Repo root, derived from this file's location (src/repro_torch/analysis/base.py).
REPO_ROOT = Path(__file__).resolve().parents[3]

#: Default analysis target.
DEFAULT_TARGET = REPO_ROOT / "src" / "repro_torch"

#: Committed exceptions file (JSON list of {"key":..., "reason":...}).
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit: stable ``key`` for baselining, ``line`` for humans."""

    check: str    # e.g. "LOCK-ORDER" — must be one of repro_torch.analysis.CHECK_IDS
    path: str     # repo-relative posix path, e.g. "src/repro_torch/api/admin.py"
    line: int     # 1-based line of the offending node
    scope: str    # dotted qualname of the enclosing def/class, or "<module>"
    message: str  # human-readable explanation

    #: Short stable token distinguishing findings within one scope
    #: (e.g. the blocked call name, the event kind, the metric family).
    detail: str = ""

    @property
    def key(self) -> str:
        return f"{self.check}:{self.path}:{self.scope}:{self.detail}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.check} [{self.scope}] {self.message}"


@dataclasses.dataclass
class SourceFile:
    """A parsed module: ``tree`` has ``.parent`` links on every node."""

    path: str          # repo-relative posix path
    text: str
    tree: ast.Module

    @property
    def name(self) -> str:
        return Path(self.path).name


@dataclasses.dataclass
class AnalysisResult:
    findings: list
    files: int

    def split(self, baseline: "Baseline"):
        """Partition into (new, baselined) against the committed baseline."""
        new, old = [], []
        for f in self.findings:
            (old if baseline.covers(f) else new).append(f)
        return new, old


class Baseline:
    """The committed exception list. Every entry needs a ``reason`` —
    an entry without one is itself a failure (the CLI enforces this)."""

    def __init__(self, entries=None):
        self.entries = list(entries or [])
        self._keys = {e.get("key") for e in self.entries}
        self._hit = set()

    @classmethod
    def load(cls, path: Path = BASELINE_PATH) -> "Baseline":
        if not path.exists():
            return cls([])
        return cls(json.loads(path.read_text()))

    def covers(self, finding: Finding) -> bool:
        if finding.key in self._keys:
            self._hit.add(finding.key)
            return True
        return False

    def unjustified(self):
        return [e for e in self.entries if not str(e.get("reason", "")).strip()]

    def stale(self):
        """Entries that matched nothing — the exception no longer exists
        and should be deleted rather than silently carried forward."""
        return [e for e in self.entries if e.get("key") not in self._hit]


def annotate_parents(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node
    return tree


def scope_of(node: ast.AST) -> str:
    """Dotted qualname of the innermost enclosing def/class chain."""
    parts = []
    cur = getattr(node, "parent", None)
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        parts.append(node.name)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "parent", None)
    return ".".join(reversed(parts)) or "<module>"


def dotted_name(node: ast.AST) -> str:
    """Render Name/Attribute chains as 'a.b.c' ('' for anything dynamic)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def parse_source(path: Path, root: Path) -> SourceFile:
    text = path.read_text()
    tree = ast.parse(text, filename=str(path))
    annotate_parents(tree)
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    return SourceFile(path=rel, text=text, tree=tree)


def load_sources(root=None) -> list:
    """Parse every ``*.py`` under ``src/repro_torch`` (or ``root``), returning
    :class:`SourceFile` objects with repo-relative paths. Skips caches."""
    root = Path(root) if root else REPO_ROOT
    target = root / "src" / "repro_torch"
    if not target.exists():  # analyzing an arbitrary tree (tests do this)
        target = root
    sources = []
    for path in sorted(target.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        sources.append(parse_source(path, root))
    return sources
