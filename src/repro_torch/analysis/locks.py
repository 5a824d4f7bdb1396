"""LOCK-BLOCKING and LOCK-ORDER: static lock-discipline checks (the
port's copy of ``src/repro/analysis/locks.py``; ``LOCK_LATTICE`` and both
rules unchanged).

The platform's locks form a three-level lattice, acquired strictly
downward (a holder may only acquire lower levels):

    plane (2)   AdminPlane/WorkloadPlane ``_mutex`` RLocks, entered via
                the ``_serialized`` decorator
    shard (1)   per-shard ``RWLock`` (``read_locked``/``write_locked``,
                the gateway's ``_tenant_locked``/``_job_locked`` wrappers,
                and ``AllShardsLock`` which takes every shard lock in
                router order — the one sanctioned shard-while-shard site)
    leaf  (0)   internal mutexes/conditions (``self._lock``, ``_cond``,
                ``_metrics_lock``, ...) that never nest outward

Two rules, both intraprocedural (the runtime witness in
:mod:`repro_torch.analysis.witness` covers what lexical analysis cannot):

* **LOCK-ORDER** — inside a region holding level L, acquiring level
  M >= L is a violation, except leaf-in-leaf (unordered internal
  mutexes never nest outward) and plane-in-plane (reentrant RLock).
  Shard-while-shard is flagged even when hand-sorted — such sites must
  carry a baseline justification tying them to AllShardsLock's total
  order (``AdminPlane._cutover`` is the one such site today).

* **LOCK-BLOCKING** — no sleeping, file/WAL flushing, or socket I/O
  while holding a shard or plane lock. Leaf locks are exempt: the
  MetaStore group-commit flushes its WAL under its own leaf mutex by
  design, and that's the level where it is safe.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Finding, dotted_name, scope_of

#: The declared lattice (documented in docs/architecture.md; higher
#: acquires lower, never the reverse).
LOCK_LATTICE = {"plane": 2, "shard": 1, "leaf": 0}

#: Attribute-call names that acquire a shard-level lock.
_SHARD_CALLS = {"read_locked", "write_locked", "_tenant_locked", "_job_locked"}

#: Constructors treated as shard-level acquisitions (sanctioned total
#: order internally, but still a shard hold for what runs under them).
_SHARD_CTORS = {"AllShardsLock"}

#: Bare context-manager attributes that are plane mutexes.
_PLANE_ATTRS = {"_mutex"}

#: Blocking calls, as dotted names and bare attribute names.
_BLOCKING_DOTTED = {
    "time.sleep",
    "os.fsync",
    "socket.create_connection",
    "deadline_sleep",
    "urlopen",
    "open",
}
_BLOCKING_ATTRS = {
    "sleep",
    "fsync",
    "flush",
    "sendall",
    "recv",
    "sendfile",
    "getresponse",
    "urlopen",
    "deadline_sleep",
}


def _classify(expr: ast.AST):
    """Map a ``with`` item's context expression to a lattice level.

    Returns ``(level, label)`` or ``None`` for non-lock managers
    (``deadline_scope``, ``ExitStack``, files opened via with, ...).
    """
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _SHARD_CALLS:
                return "shard", dotted_name(fn)
        if isinstance(fn, ast.Name):
            if fn.id in _SHARD_CALLS:
                return "shard", fn.id
            if fn.id in _SHARD_CTORS:
                return "shard", fn.id
        return None
    # Bare lock objects used directly as context managers.
    if isinstance(expr, ast.Attribute):
        attr = expr.attr
        if attr in _PLANE_ATTRS:
            return "plane", dotted_name(expr)
        if attr.startswith("_") and any(t in attr for t in ("lock", "mutex", "cond")):
            return "leaf", dotted_name(expr)
    if isinstance(expr, ast.Name):
        nid = expr.id
        if nid.startswith("_") and any(t in nid for t in ("lock", "mutex", "cond")):
            return "leaf", nid
    return None


def _is_serialized(func: ast.AST) -> bool:
    for dec in func.decorator_list:
        name = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(name).split(".")[-1] == "_serialized":
            return True
    return False


def _blocking_label(call: ast.Call):
    """Return a label if ``call`` is a known blocking primitive."""
    fn = call.func
    dn = dotted_name(fn)
    if dn in _BLOCKING_DOTTED:
        return dn
    if isinstance(fn, ast.Attribute) and fn.attr in _BLOCKING_ATTRS:
        return dn or fn.attr
    return None


class _FunctionLockWalker:
    """Walk one function's statements with a held-lock stack, emitting
    LOCK-ORDER on upward acquisitions and LOCK-BLOCKING on blocking
    calls under shard/plane holds. Nested defs are skipped here (they
    execute later; each gets its own top-level pass)."""

    def __init__(self, src, func, findings):
        self.src = src
        self.func = func
        self.findings = findings
        self.held = ["plane"] if _is_serialized(func) else []

    def run(self):
        for stmt in self.func.body:
            self._visit(stmt)

    def _visit(self, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # analyzed separately with its own (empty) stack
        if isinstance(node, ast.With):
            self._visit_with(node)
            return
        if isinstance(node, ast.Call):
            self._check_blocking(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _pop(self, n):
        if n:
            del self.held[-n:]

    def _visit_with(self, node: ast.With):
        pushed = 0
        for item in node.items:
            # expressions inside the item may themselves contain calls
            self._visit(item.context_expr)
            cls = _classify(item.context_expr)
            if cls is None:
                continue
            level, label = cls
            self._check_order(node, level, label)
            self.held.append(level)
            pushed += 1
        for stmt in node.body:
            self._visit(stmt)
        self._pop(pushed)

    def _check_order(self, node, level, label):
        for held in self.held:
            ok = LOCK_LATTICE[level] < LOCK_LATTICE[held]
            # Sanctioned same-level reentry: leaf-in-leaf (unordered
            # internal mutexes) and plane-in-plane (reentrant RLock).
            if level == held and level in ("leaf", "plane"):
                ok = True
            if not ok:
                self.findings.append(Finding(
                    check="LOCK-ORDER",
                    path=self.src.path,
                    line=node.lineno,
                    scope=scope_of(self.func),
                    message=(
                        f"acquires {level} lock `{label}` while already "
                        f"holding a {held} lock — violates the "
                        f"plane->shard->leaf lattice"
                    ),
                    detail=label,
                ))
                return

    def _check_blocking(self, call: ast.Call):
        # children are visited by the caller's generic loop
        if not any(h in ("shard", "plane") for h in self.held):
            return
        label = _blocking_label(call)
        if label:
            outer = "plane" if "plane" in self.held else "shard"
            self.findings.append(Finding(
                check="LOCK-BLOCKING",
                path=self.src.path,
                line=call.lineno,
                scope=scope_of(self.func),
                message=(
                    f"blocking call `{label}` while holding a {outer} "
                    f"lock — sleeps/flushes/socket I/O must happen "
                    f"outside shard and plane critical sections"
                ),
                detail=label,
            ))


def check_locks(sources) -> list:
    findings = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # AllShardsLock's internals ARE the sanctioned total order;
            # RWLock's internals only touch its own leaf condition.
            if scope_of(node).split(".")[0] in ("AllShardsLock",):
                continue
            _FunctionLockWalker(src, node, findings).run()
    return findings
