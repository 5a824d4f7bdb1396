"""DEADLINE-VERB: every gateway verb runs under a deadline scope (the
port's copy of ``src/repro/analysis/deadlines.py``, unchanged).

The platform's thread-local deadlines (``deadline_scope``) turn a
gray-failing shard into a bounded 504 instead of a wedged caller, and
every v1 verb is wrapped in the ``_deadlined`` decorator. The check
generalizes the rule: **any public method of a ``*Gateway`` class whose
first parameter is ``api_key`` is a wire verb**, and a wire verb must
either carry a deadline decorator (``_deadlined`` / anything built from
``deadline_guarded``) or open ``with deadline_scope(...)`` itself.

A verb without a budget would let a cutover stuck behind a slow shard
hold its caller forever; the v2 planes' AdminGateway and WorkloadGateway
take theirs from ``repro_torch.api.types.deadline_guarded``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Finding, dotted_name

#: Decorator names that satisfy the requirement.
_DEADLINE_DECORATORS = {"_deadlined", "deadline_guarded", "deadlined"}


def _has_deadline_decorator(func) -> bool:
    for dec in func.decorator_list:
        name = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(name).split(".")[-1] in _DEADLINE_DECORATORS:
            return True
    return False


def _opens_deadline_scope(func) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    if dotted_name(expr.func).split(".")[-1] == "deadline_scope":
                        return True
    return False


def _is_verb(func) -> bool:
    if func.name.startswith("_"):
        return False
    args = func.args.posonlyargs + func.args.args
    names = [a.arg for a in args]
    return len(names) >= 2 and names[0] == "self" and names[1] == "api_key"


def check_deadlines(sources) -> list:
    findings = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not node.name.endswith("Gateway"):
                continue
            for func in node.body:
                if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if not _is_verb(func):
                    continue
                if _has_deadline_decorator(func) or _opens_deadline_scope(func):
                    continue
                findings.append(Finding(
                    check="DEADLINE-VERB",
                    path=src.path,
                    line=func.lineno,
                    scope=f"{node.name}.{func.name}",
                    message=(
                        f"wire verb `{node.name}.{func.name}` runs "
                        f"without a deadline_scope — a gray-failing "
                        f"shard wedges the caller forever; wrap it in "
                        f"`_deadlined`/`deadline_guarded`"
                    ),
                    detail=func.name,
                ))
    return findings
