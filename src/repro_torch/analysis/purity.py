"""PURITY-CALL and PURITY-MUTATION: registered-pure policy cores (the
port's copy of ``src/repro/analysis/purity.py``; ``PURE_REGISTRY`` names the
same eight functions in the port's own files, under ``src/repro_torch/``).

The platform's control loops all follow the same shape: an impure shell
gathers an observation snapshot, a **pure** ``decide()`` turns it into a
list of action dicts, and the shell applies them. That purity is what
makes operator/reconciler/breaker decisions replayable and unit-testable
without a live platform — and it is exactly the property a refactor
silently breaks by reaching for ``time.time()`` or mutating the
observation in place.

``PURE_REGISTRY`` names the functions the platform promises are pure.
For each, the checker:

* **PURITY-CALL** — transitively follows same-file calls
  (``self.helper(...)``, bare module functions, ``Class.helper``) and
  flags any reachable I/O, ambient clock, or RNG use. Cross-module
  calls are not followed (the registry lists entry points whose helper
  graphs are file-local by construction).
* **PURITY-MUTATION** — flags statements in the *entry* function that
  mutate a parameter: subscript/attribute stores rooted at a parameter,
  or mutating method calls (``append``/``update``/``sort``/...) on one.
  Rebinding a parameter name (``outcomes = list(outcomes)``) untracks
  it — that's the sanctioned defensive-copy idiom. Helpers may mutate
  their own parameters (e.g. an ``out`` accumulator passed by the entry
  function); only the entry function's inputs are protected.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Finding, dotted_name, scope_of

#: (repo-relative path, dotted qualname) of every function the platform
#: declares pure. docs/architecture.md tables this list.
PURE_REGISTRY = (
    ("src/repro_torch/obs/operator.py", "OperatorPolicy.decide"),
    ("src/repro_torch/workloads/reconciler.py", "ReconcilerPolicy.decide"),
    ("src/repro_torch/core/faults.py", "BreakerPolicy.step"),
    ("src/repro_torch/core/faults.py", "BreakerPolicy.observe"),
    ("src/repro_torch/core/faults.py", "BreakerPolicy.allow_request"),
    ("src/repro_torch/api/router.py", "encode_composite_cursor"),
    ("src/repro_torch/api/router.py", "parse_composite_cursor"),
    ("src/repro_torch/obs/bus.py", "event_to_wire"),
)

#: Calls that are impure on sight inside a pure function.
_IMPURE_EXACT = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.sleep",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "open", "print", "input", "deadline_sleep",
}
_IMPURE_PREFIXES = (
    "random.", "np.random.", "numpy.random.",
    "os.", "socket.", "urllib.", "subprocess.", "sys.",
    "logging.",
)

#: Method names that mutate their receiver in place.
_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "update", "setdefault", "popitem", "add", "discard",
    "appendleft", "popleft",
}


def _index_file(src):
    """Map dotted qualnames -> function nodes for one module."""
    table = {}
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            table[scope_of(node)] = node
    return table


def _resolve_callee(call: ast.Call, entry_scope: str, table):
    """Resolve a call to a same-file function node, or None.

    ``self.helper(...)`` -> method of the entry's class; bare names ->
    module-level function; ``Class.helper(...)`` -> that method.
    """
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        if fn.value.id == "self" and "." in entry_scope:
            cls = entry_scope.rsplit(".", 1)[0]
            return table.get(f"{cls}.{fn.attr}")
        return table.get(f"{fn.value.id}.{fn.attr}")
    if isinstance(fn, ast.Name):
        return table.get(fn.id)
    return None


def _impure_label(call: ast.Call):
    dn = dotted_name(call.func)
    if dn in _IMPURE_EXACT:
        return dn
    if dn and dn.startswith(_IMPURE_PREFIXES):
        return dn
    return None


def _check_calls(src, entry_name, qualname, node, table, visited, findings):
    if qualname in visited:
        return
    visited.add(qualname)
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        label = _impure_label(call)
        if label:
            via = "" if qualname == entry_name else f" (via `{qualname}`)"
            findings.append(Finding(
                check="PURITY-CALL",
                path=src.path,
                line=call.lineno,
                scope=entry_name,
                message=(
                    f"registered-pure `{entry_name}` reaches impure call "
                    f"`{label}`{via}"
                ),
                detail=label,
            ))
            continue
        callee = _resolve_callee(call, qualname, table)
        if callee is not None:
            _check_calls(src, entry_name, scope_of(callee), callee,
                         table, visited, findings)


def _param_names(func):
    a = func.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _root_name(node):
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _check_mutation(src, entry_name, func, findings):
    params = set(_param_names(func))
    # A parameter rebound to a fresh object anywhere in the body is the
    # defensive-copy idiom; stop tracking it entirely (flow-insensitive
    # but safe: the copy shadows the caller's object).
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                for name in ast.walk(tgt):
                    if isinstance(name, ast.Name) and isinstance(
                            name.ctx, ast.Store) and name.id in params:
                        params.discard(name.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node.target, ast.Name):
                params.discard(node.target.id)
    if not params:
        return

    def flag(node, root, what):
        findings.append(Finding(
            check="PURITY-MUTATION",
            path=src.path,
            line=node.lineno,
            scope=entry_name,
            message=(
                f"registered-pure `{entry_name}` mutates its input "
                f"`{root}` ({what}) — copy before editing"
            ),
            detail=root,
        ))

    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                    root = _root_name(tgt)
                    if root in params:
                        flag(node, root, "item/attribute store")
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                    root = _root_name(tgt)
                    if root in params:
                        flag(node, root, "del")
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATING_METHODS:
                root = _root_name(fn.value)
                if root in params:
                    flag(node, root, f".{fn.attr}() call")


def check_purity(sources, registry=PURE_REGISTRY) -> list:
    findings = []
    by_path = {s.path: s for s in sources}
    for path, qualname in registry:
        src = by_path.get(path)
        if src is None:
            # Fixture trees won't contain the real registry paths;
            # missing *files* are skipped, missing *functions* are not.
            continue
        table = _index_file(src)
        func = table.get(qualname)
        if func is None:
            findings.append(Finding(
                check="PURITY-CALL",
                path=path,
                line=1,
                scope=qualname,
                message=(
                    f"purity registry names `{qualname}` but no such "
                    f"function exists in {path} — fix the registry"
                ),
                detail="missing",
            ))
            continue
        _check_calls(src, qualname, qualname, func, table, set(), findings)
        _check_mutation(src, qualname, func, findings)
    return findings
