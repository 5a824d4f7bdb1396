"""REG-EVENT / REG-METRIC / REG-ROUTE: wire registries vs. reality (the
port's copy of ``src/repro/analysis/registry.py``, unchanged: it finds the
tables wherever the analyzed tree defines them, in the port the
``ROUTES``/``*_ROUTES``/``ROUTE_HANDLERS`` of ``api/http.py``,
``PLATFORM_EVENT_KINDS`` and ``METRIC_NAMES``).

The wire contract lives in five hand-pinned tables — ``ROUTES`` /
``ADMIN_ROUTES`` / ``WORKLOAD_ROUTES`` / ``OBS_ROUTES`` (plus the
``ROUTE_HANDLERS`` dispatch table), ``PLATFORM_EVENT_KINDS``, and
``METRIC_NAMES``. docs/api.md is already pinned against the tables;
this checker pins the tables against the *code*:

* **REG-EVENT** — every literal kind passed to an ``emit()`` site must
  be in ``PLATFORM_EVENT_KINDS`` (an operator keying automation on
  /v2/events must be able to trust the vocabulary is complete), and
  every registered kind must still be mentioned by some emit site or
  kind table (no zombie vocabulary). Kinds emitted through variables
  are out of static reach — the vocabulary tuples those variables draw
  from are literals, so the reverse direction still covers them.
* **REG-METRIC** — the family names rendered by
  ``collect_metric_families`` and the ``METRIC_NAMES`` registry must
  match exactly, both directions.
* **REG-ROUTE** — ``ROUTE_HANDLERS`` keys must equal the union of the
  ``*_ROUTES`` tables; every handler it names must exist; every
  ``_h_*`` handler defined must be routed. A route table without a
  ``ROUTE_HANDLERS`` dispatch table at all is itself a finding: routes
  reachable only through an if-chain are exactly the drift this check
  exists to prevent.

Each sub-check only runs when its registry is present in the analyzed
tree, so fixture snippets can exercise one invariant in isolation.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Finding, scope_of

_METRIC_TYPES = {"counter", "gauge", "histogram"}


def _find_assign(sources, name):
    """Locate ``name = <literal>`` at module level. Returns
    (source, assign_node, value_node) or None."""
    for src in sources:
        for node in src.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == name:
                        return src, node, node.value
            elif isinstance(node, ast.AnnAssign):
                if (isinstance(node.target, ast.Name)
                        and node.target.id == name and node.value):
                    return src, node, node.value
    return None


def _str_elts(value_node):
    out = []
    for elt in getattr(value_node, "elts", []):
        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
            out.append((elt.value, elt.lineno))
    return out


def _emit_kind(call: ast.Call):
    """Literal kind of an emit site, or None if dynamic/not an emit.

    ``bus.emit(component, kind, **fields)`` — kind is the second
    positional or the ``kind=`` keyword. Plane-level ``self._emit``
    helpers take the kind first.
    """
    fn = call.func
    attr = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    idx = {"emit": 1, "_emit": 0}.get(attr)
    if idx is None:
        return None
    for kw in call.keywords:
        if kw.arg == "kind":
            if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
                return kw.value.value
            return None
    if len(call.args) > idx:
        arg = call.args[idx]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


def _check_events(sources, findings):
    found = _find_assign(sources, "PLATFORM_EVENT_KINDS")
    if not found:
        return
    reg_src, reg_node, reg_value = found
    kinds = {v for v, _ in _str_elts(reg_value)}
    registry_literals = set()
    for n in ast.walk(reg_node):
        registry_literals.add(id(n))

    mentioned = set()
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                kind = _emit_kind(node)
                if kind is not None and kind not in kinds:
                    findings.append(Finding(
                        check="REG-EVENT",
                        path=src.path,
                        line=node.lineno,
                        scope=scope_of(node),
                        message=(
                            f"emit kind `{kind}` is not in "
                            f"PLATFORM_EVENT_KINDS — register it (the "
                            f"/v2/events vocabulary is a wire contract)"
                        ),
                        detail=kind,
                    ))
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and id(node) not in registry_literals):
                mentioned.add(node.value)

    for kind, lineno in _str_elts(reg_value):
        if kind not in mentioned:
            findings.append(Finding(
                check="REG-EVENT",
                path=reg_src.path,
                line=lineno,
                scope="PLATFORM_EVENT_KINDS",
                message=(
                    f"registered kind `{kind}` is emitted nowhere in "
                    f"the tree — zombie vocabulary, delete or emit it"
                ),
                detail=kind,
            ))


def _check_metrics(sources, findings):
    found = _find_assign(sources, "METRIC_NAMES")
    if not found:
        return
    reg_src, _, reg_value = found
    registered = dict(_str_elts(reg_value))  # name -> line

    rendered = {}  # name -> (path, line)
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name != "collect_metric_families":
                continue
            for tup in ast.walk(node):
                if not isinstance(tup, ast.Tuple) or len(tup.elts) < 3:
                    continue
                head, kind = tup.elts[0], tup.elts[1]
                if (isinstance(head, ast.Constant) and isinstance(head.value, str)
                        and isinstance(kind, ast.Constant)
                        and kind.value in _METRIC_TYPES):
                    rendered.setdefault(head.value, (src.path, tup.lineno))

    for name, (path, line) in sorted(rendered.items()):
        if name not in registered:
            findings.append(Finding(
                check="REG-METRIC",
                path=path,
                line=line,
                scope="collect_metric_families",
                message=(
                    f"rendered family `{name}` is not in METRIC_NAMES — "
                    f"register it (family names are a wire contract)"
                ),
                detail=name,
            ))
    for name, line in sorted(registered.items()):
        if name not in rendered:
            findings.append(Finding(
                check="REG-METRIC",
                path=reg_src.path,
                line=line,
                scope="METRIC_NAMES",
                message=(
                    f"registered family `{name}` is rendered nowhere — "
                    f"zombie metric, delete or render it"
                ),
                detail=name,
            ))


def _route_pairs(value_node):
    out = []
    for elt in getattr(value_node, "elts", []):
        if isinstance(elt, ast.Tuple) and len(elt.elts) == 2:
            m, t = elt.elts
            if (isinstance(m, ast.Constant) and isinstance(t, ast.Constant)):
                out.append((f"{m.value} {t.value}", elt.lineno))
    return out


def _check_routes(sources, findings):
    tables = {}
    for src in sources:
        for node in src.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name)
                        and (tgt.id == "ROUTES" or tgt.id.endswith("_ROUTES"))
                        and tgt.id != "UNAUTHENTICATED_ROUTES"):
                    pairs = _route_pairs(node.value)
                    if pairs:
                        tables[tgt.id] = (src, node, pairs)
    if not tables:
        return

    routed = {}  # "METHOD /tpl" -> (path, line)
    table_file = None
    for tname, (src, node, pairs) in sorted(tables.items()):
        table_file = src
        for key, line in pairs:
            routed.setdefault(key, (src.path, line))

    handlers = _find_assign(sources, "ROUTE_HANDLERS")
    if handlers is None:
        src, node, _ = next(iter(tables.values()))
        findings.append(Finding(
            check="REG-ROUTE",
            path=src.path,
            line=node.lineno,
            scope="<module>",
            message=(
                "route tables exist but no ROUTE_HANDLERS dispatch "
                "table — routes must resolve to handlers declaratively, "
                "not through an if-chain"
            ),
            detail="ROUTE_HANDLERS-missing",
        ))
        return

    h_src, h_node, h_value = handlers
    mapping = {}  # "METHOD /tpl" -> (handler_name, line)
    for k, v in zip(getattr(h_value, "keys", []), getattr(h_value, "values", [])):
        if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant) and isinstance(v.value, str)):
            mapping[k.value] = (v.value, k.lineno)

    defined = {}
    for node in ast.walk(h_src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined[node.name] = node

    for key, (path, line) in sorted(routed.items()):
        if key not in mapping:
            findings.append(Finding(
                check="REG-ROUTE",
                path=path,
                line=line,
                scope="ROUTE_HANDLERS",
                message=f"route `{key}` has no ROUTE_HANDLERS entry",
                detail=key,
            ))
    for key, (handler, line) in sorted(mapping.items()):
        if key not in routed:
            findings.append(Finding(
                check="REG-ROUTE",
                path=h_src.path,
                line=line,
                scope="ROUTE_HANDLERS",
                message=(
                    f"ROUTE_HANDLERS entry `{key}` is in no *_ROUTES "
                    f"table — the pinned tables are the contract"
                ),
                detail=key,
            ))
        if handler not in defined:
            findings.append(Finding(
                check="REG-ROUTE",
                path=h_src.path,
                line=line,
                scope="ROUTE_HANDLERS",
                message=(
                    f"route `{key}` names handler `{handler}` which is "
                    f"not defined in {h_src.name}"
                ),
                detail=handler,
            ))
    wired = {handler for handler, _ in mapping.values()}
    for name, node in sorted(defined.items()):
        if name.startswith("_h_") and name not in wired:
            findings.append(Finding(
                check="REG-ROUTE",
                path=h_src.path,
                line=node.lineno,
                scope=scope_of(node),
                message=(
                    f"handler `{name}` is defined but routed nowhere — "
                    f"dead endpoint or missing ROUTE_HANDLERS entry"
                ),
                detail=name,
            ))


def check_registries(sources) -> list:
    findings = []
    _check_events(sources, findings)
    _check_metrics(sources, findings)
    _check_routes(sources, findings)
    return findings
