"""Run a reference test module's scenarios on both packages and compare the
traces they leave (tests/test_torch_admin.py, test_torch_workloads.py and
test_torch_federation.py).

A reference test file (``tests/test_admin_plane.py`` and the like) is
compiled twice from its own source: once as it is, against ``repro``, and
once with every ``from repro... import`` read as ``from repro_torch...
import``. A name the port's module lacks is looked up in that module's
package (the reference's ``repro.api.http`` re-exports
``RateLimitConfig``, which the port keeps in ``repro_torch.api``); a name
the port's package lacks too is left unbound. Those are the reference's
HTTP transport and CLI (ROADMAP A.19), and the scenarios that reach them
are the ones each parity file lists as waiting.

Each scenario (a test function of the module, one case of each of its
parametrizations, each property test at fixed seeds) then runs once on
each side under a ``Recorder``, which notes:

  * every verb of the v1 gateway, the v2 admin and workloads gateways, the
    rate-limited front and the token bucket, with its arguments and its response as the
    wire carries it (dataclasses as dicts, enums as their values, errors as
    code, message and details);
  * at the scenario's end, for every platform it built: the event bus
    (seq, time, component, kind, fields, tenant), the metastore's journal
    and each job record; and for every federation: the migrations (their
    phases and counts), the workloads' specs and status blocks, the
    reconciler's decision journal and, where one is installed, the
    operator's status and journal.

Both sides must pass the scenario's own assertions, and leave equal traces
(a scenario of pure functions, such as the manifest parser's, leaves none:
its assertions are the comparison). The scenarios that start threads record
only from one thread, or record the same entry from each.
"""

import ast
import dataclasses
import enum
import importlib
import inspect
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

# The property tests' seeds on both sides (hypothesis would draw others on
# each run, and the traces would not compare)
PROPERTY_SEEDS = (0, 1, 7, 42, 1234, 99991, 500000, 10**6)


# --------------------------------------------------------------------------
# compiling a reference test module against either package
# --------------------------------------------------------------------------

def _port_name(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _lookup(module: str, name: str):
    """The port module that defines ``name`` for ``from module import
    name``: the module itself, else its package; None if neither has it."""
    candidates = [module]
    if "." in module:
        candidates.append(module.rsplit(".", 1)[0])
    for mod in candidates:
        try:
            found = importlib.import_module(mod)
        except ModuleNotFoundError:
            continue
        if hasattr(found, name):
            return mod
        try:
            importlib.import_module(f"{mod}.{name}")
            return mod
        except ModuleNotFoundError:
            continue
    return None


class _ToPort(ast.NodeTransformer):
    """``from repro.X import a, b`` → ``from repro_torch.X import a, b``,
    each name from the port module that defines it, unbound names left
    out (recorded in ``unbound``)."""

    def __init__(self):
        self.unbound = set()

    def visit_ImportFrom(self, node):
        if node.module is None or not (node.module == "repro"
                                       or node.module.startswith("repro.")):
            return node
        port = _port_name(node.module)
        out = []
        for alias in node.names:
            where = _lookup(port, alias.name)
            if where is None:
                self.unbound.add(alias.asname or alias.name)
                continue
            out.append(ast.copy_location(
                ast.ImportFrom(module=where, names=[alias], level=0), node))
        return out or ast.copy_location(ast.Pass(), node)

    def visit_Import(self, node):
        assert not any(a.name.split(".")[0] == "repro" for a in node.names), \
            "plain `import repro...` is not rewritten"
        return node


def load(stem: str, port: bool):
    """The reference test module ``tests/{stem}.py`` compiled against the
    reference (``port=False``) or the port. Returns (module, unbound
    names)."""
    path = TESTS / f"{stem}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    unbound = set()
    if port:
        rewrite = _ToPort()
        tree = ast.fix_missing_locations(rewrite.visit(tree))
        unbound = rewrite.unbound
    name = f"_mirror_{'port' if port else 'ref'}_{stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod, unbound


def _code_names(code) -> set:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


def reaches(fn, names: set, module) -> bool:
    """Whether ``fn`` (or a helper of its module it calls, one level deep)
    names one of ``names``."""
    used = _code_names(fn.__code__)
    if used & names:
        return True
    helpers = [getattr(module, n) for n in used
               if inspect.isfunction(getattr(module, n, None))]
    return any(_code_names(h.__code__) & names for h in helpers)


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

def _raw_fixture(fixture):
    wrapped = getattr(fixture, "__pytest_wrapped__", None)
    if wrapped is not None:
        return wrapped.obj
    return getattr(fixture, "__wrapped__", fixture)


def _inner(fn):
    """A property test's undecorated body (hypothesis or the vendored
    ``_propstrat`` fallback), or None for a plain test."""
    hyp = getattr(fn, "hypothesis", None)
    if hyp is not None:
        return hyp.inner_test
    if hasattr(fn, "_max_examples"):
        return inspect.unwrap(fn)
    return None


def _parametrize(fn):
    """[(id, {argname: value})] over the test's parametrize marks."""
    cases = [("", {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        grown = []
        for cid, kw in cases:
            for i, v in enumerate(values):
                v = getattr(v, "values", v)  # pytest.param
                vals = v if len(names) > 1 else (v,)
                grown.append((f"{cid}{'-' if cid else ''}{i}", {**kw, **dict(zip(names, vals))}))
        cases = grown
    return cases


def scenarios(stem: str):
    """The scenario ids of a reference test module, as ``stem::name`` or
    ``stem::name[case]``: one per test function, parametrization case and
    property test."""
    mod, _ = load(stem, port=False)
    out = []
    for name, fn in vars(mod).items():
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        for cid, _kw in _parametrize(fn):
            out.append(f"{stem}::{name}" + (f"[{cid}]" if cid else ""))
    return out


def _split(scenario: str):
    stem, rest = scenario.split("::")
    name, _, cid = rest.partition("[")
    return stem, name, cid.rstrip("]")


def run(mod, scenario: str):
    """Run one scenario of ``mod``: resolve its fixtures (the module's
    own), its parametrization case, and a property test's seeds."""
    _, name, cid = _split(scenario)
    fn = getattr(mod, name)
    kwargs = dict(_parametrize(fn))[cid]
    inner = _inner(fn)
    body = inner or fn
    for param in inspect.signature(body).parameters:
        if param not in kwargs and not (inner is not None and param == "seed"):
            kwargs[param] = _raw_fixture(getattr(mod, param))()
    if inner is None:
        return fn(**kwargs)
    for seed in PROPERTY_SEEDS:
        inner(seed=seed, **kwargs)


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def wire(x):
    """``x`` as the wire would carry it."""
    if isinstance(x, enum.Enum):
        return wire(x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: wire(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {wire(k): wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [wire(v) for v in x]
    if isinstance(x, BaseException):
        if hasattr(x, "code") and hasattr(x, "details"):  # ApiError
            return {"error": wire(x.code), "message": str(x), "details": wire(x.details)}
        return {"raised": type(x).__name__, "message": str(x)}
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    return f"<{type(x).__name__}>"


# The verb surfaces recorded, by (module, class)
SURFACES = (("api.gateway", "ApiGateway"), ("api.admin", "AdminGateway"),
            ("workloads.plane", "WorkloadGateway"), ("api.ratelimit", "RateLimitedApi"),
            ("api.ratelimit", "TokenBucket"))


class Recorder:
    """Records one side's verbs and collects the platforms and federations
    a scenario builds, through ``monkeypatch`` (undone at the test's end)."""

    def __init__(self, pkg: str, monkeypatch):
        self.pkg = pkg
        self.wire, self.platforms, self.federations = [], [], []
        for mod, cls in SURFACES:
            klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)
            for verb, fn in list(vars(klass).items()):
                if not verb.startswith("_") and inspect.isfunction(fn):
                    monkeypatch.setattr(klass, verb, self._verb(cls, verb, fn))
        fed = importlib.import_module(f"{pkg}.api.federation").Federation
        plat = importlib.import_module(f"{pkg}.core.platform").FfDLPlatform
        monkeypatch.setattr(fed, "__init__", self._built(fed.__init__, self.federations))
        monkeypatch.setattr(plat, "__init__", self._built(plat.__init__, self.platforms))

    def _verb(self, cls, verb, fn):
        log = self.wire

        def call(obj, *args, **kwargs):
            try:
                out = fn(obj, *args, **kwargs)
            except Exception as e:
                log.append((cls, verb, wire(args), wire(kwargs), wire(e)))
                raise
            log.append((cls, verb, wire(args), wire(kwargs), wire(out)))
            return out
        return call

    @staticmethod
    def _built(init, into):
        def built(obj, *args, **kwargs):
            init(obj, *args, **kwargs)
            into.append(obj)
        return built

    def observed(self) -> dict:
        platforms = []
        for p in self.platforms:
            platforms.append({
                "events": [(e.seq, e.ts, e.component, e.kind, wire(e.fields), e.tenant)
                           for e in p.events.events],
                "journal": wire(p.meta._journal),
                "records": {rec.job_id: wire((rec.status, rec.status_history, rec.placement,
                                              rec.restarts, rec.progress_step))
                            for rec in p.meta.jobs()},
                "workloads": wire(p.workloads.list())})
        federations = []
        for f in self.federations:
            federations.append({
                "shards": [p.backend.shard_id for p in f.shards],
                "migrations": wire(f.admin.list_migrations()),
                "tenants": wire(sorted(f.admin.tenants)),
                "workloads": wire(f.workloads.list()),
                "decisions": wire(f.reconciler.journal()),
                "operator": wire(f.operator.status_view()) if f.operator is not None else None})
        return {"wire": self.wire, "platforms": platforms, "federations": federations}


def mirror(scenario: str, monkeypatch):
    """Run ``scenario`` on the reference, then on the port, each under a
    recorder, and hold the port's trace to the reference's."""
    stem = _split(scenario)[0]
    traces = {}
    for side, pkg in (("reference", "repro"), ("port", "repro_torch")):
        mod, _ = load(stem, port=side == "port")
        with monkeypatch.context() as m:
            rec = Recorder(pkg, m)
            run(mod, scenario)
            traces[side] = rec.observed()
    ref, port = traces["reference"], traces["port"]
    assert len(port["wire"]) == len(ref["wire"])
    for i, (a, b) in enumerate(zip(ref["wire"], port["wire"])):
        assert b == a, ("wire", i)
    for key in ("platforms", "federations"):
        assert len(port[key]) == len(ref[key]), key
        for i, (a, b) in enumerate(zip(ref[key], port[key])):
            for part in a:
                assert b[part] == a[part], (key, i, part)


def waiting(stem: str) -> list:
    """The scenarios of ``stem`` that reach a name the port does not
    define (the reference's HTTP transport and CLI)."""
    mod, unbound = load(stem, port=True)
    return sorted(s for s in scenarios(stem)
                  if reaches(getattr(mod, _split(s)[1]), unbound, mod))

