"""Run a reference test module's scenarios on both packages and compare the
traces they leave (tests/test_torch_admin.py, test_torch_workloads.py,
test_torch_federation.py, test_torch_http.py, test_torch_faults.py,
test_torch_control.py and test_torch_analysis.py).

A reference test file (``tests/test_admin_plane.py`` and the like) is
compiled twice from its own source: once as it is, against ``repro``, and
once with every ``from repro... import`` read as ``from repro_torch...
import`` (and ``import repro.X as y`` as ``import repro_torch.X as y``).
A name the port's module lacks is looked up in that module's package; a
name the port's package lacks too is left unbound, and the scenarios that
reach one are the ones a parity file lists as waiting. Both compilations
draw their property tests with the vendored ``_propstrat`` (a fixed-seed
sweep), so both sides see the same examples. A scenario is a test
function or a ``Test*`` class's method; its fixtures are the module's own
(a generator fixture's teardown runs at the scenario's end), pytest's
``capsys`` and ``tmp_path``, and a ``monkeypatch`` of its own. A parity
file that imports ``port_witness`` has the port's lock-order witness
installed for the module and asserted acyclic at its end.

Each scenario (a test function of the module, one case of each of its
parametrizations, each property test at fixed seeds) then runs once on
each side under a ``Recorder``, which notes:

  * every verb of the v1 gateway, the v2 admin and workloads gateways, the
    rate-limited front and the token bucket, with its arguments and its
    response as the wire carries it (dataclasses as dicts, enums as their
    values, errors as code, message and details);
  * every JSON response of the HTTP server: its request line, status
    code, added headers (``Retry-After``) and body;
  * at the scenario's end, for every platform it built: the event bus
    (seq, time, component, kind, fields, tenant), the metastore's journal
    and each job record; and for every federation: the migrations (their
    phases and counts), the workloads' specs and status blocks, the
    reconciler's decision journal and, where one is installed, the
    operator's status and journal.

Both sides must pass the scenario's own assertions, and leave equal traces
(a scenario of pure functions, such as the manifest parser's, leaves none:
its assertions are the comparison). Over HTTP the verbs run on the
server's handler threads, in the order one client thread sends them. A
scenario whose threads or wall clock make its trace differ from run to run
on one package alone compares without its order (``mirror``'s ``order``),
and its parity file names it and says why.
"""

import ast
import collections
import dataclasses
import enum
import functools
import importlib
import inspect
import sys
import threading
import types
from pathlib import Path

import pytest

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
        """``import repro.X as y`` → ``import repro_torch.X as y``."""
        for alias in node.names:
            if alias.name.split(".")[0] != "repro":
                continue
            assert alias.asname is not None, "plain `import repro...` binds `repro`"
            alias.name = _port_name(alias.name)
        return node


class _Propstrat(ast.NodeTransformer):
    """``from hypothesis import given, settings, strategies as st`` →
    ``from _propstrat import given, settings, st``: the vendored fixed-seed
    sweep, which draws the same examples on both sides."""

    def visit_ImportFrom(self, node):
        if node.module != "hypothesis":
            return node
        names = [ast.alias(name="st", asname=a.asname) if a.name == "strategies"
                 else a for a in node.names]
        return ast.copy_location(ast.ImportFrom(module="_propstrat", names=names, level=0),
                                 node)


def load(stem: str, port: bool):
    """The reference test module ``tests/{stem}.py`` compiled against the
    reference (``port=False``) or the port, its property tests drawn by
    ``_propstrat``. Returns (module, unbound names)."""
    path = TESTS / f"{stem}.py"
    tree = _Propstrat().visit(ast.parse(path.read_text(), filename=str(path)))
    unbound = set()
    if port:
        rewrite = _ToPort()
        tree = rewrite.visit(tree)
        unbound = rewrite.unbound
    tree = ast.fix_missing_locations(tree)
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
    """A property test's undecorated body (``load`` draws every property
    test with ``_propstrat``), or None for a plain test."""
    inner = inspect.unwrap(fn)
    return None if inner is fn else inner


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


def _tests(mod):
    """[(qualified name, function)]: the module's test functions, then the
    test methods of its ``Test*`` classes as ``Class::name``."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            out.append((name, obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            out += [(f"{name}::{m}", fn) for m, fn in vars(obj).items()
                    if m.startswith("test_") and inspect.isfunction(fn)]
    return out


def scenarios(stem: str):
    """The scenario ids of a reference test module, as ``stem::name``,
    ``stem::Class::name`` or either with ``[case]``: one per test function
    or method, parametrization case and property test."""
    mod, _ = load(stem, port=False)
    out = []
    for qual, fn in _tests(mod):
        for cid, _kw in _parametrize(fn):
            out.append(f"{stem}::{qual}" + (f"[{cid}]" if cid else ""))
    return out


def _split(scenario: str):
    stem, rest = scenario.split("::", 1)
    qual, _, cid = rest.partition("[")
    return stem, qual, cid.rstrip("]")


def _target(mod, qual: str):
    """The test function of ``qual`` and its class (None for a module-level
    test)."""
    cls_name, _, name = qual.rpartition("::")
    if not cls_name:
        return getattr(mod, name), None
    cls = getattr(mod, cls_name)
    return vars(cls)[name], cls


def _monkeypatch(teardowns: list):
    mp = pytest.MonkeyPatch()
    teardowns.append(mp.undo)
    return mp


def _fixture(mod, name: str, given: dict, teardowns: list):
    """The value of fixture ``name``: one of pytest's own that the caller
    passed in ``given`` (``capsys``, ``tmp_path``), a ``monkeypatch`` of the
    scenario's own, else the module's, its own fixtures resolved first; a
    generator fixture's teardown is queued."""
    if name in given:
        return given[name]
    if name == "monkeypatch":
        return _monkeypatch(teardowns)
    raw = _raw_fixture(getattr(mod, name))
    kwargs = {p: _fixture(mod, p, given, teardowns) for p in inspect.signature(raw).parameters}
    if not inspect.isgeneratorfunction(raw):
        return raw(**kwargs)
    gen = raw(**kwargs)
    teardowns.append(lambda: next(gen, None))
    return next(gen)


def run(mod, scenario: str, given=None):
    """Run one scenario of ``mod``: resolve its fixtures (the module's
    own, and pytest's in ``given``), its parametrization case, and a
    property test's examples (a test drawing only ``seed`` at
    ``PROPERTY_SEEDS``, any other at ``_propstrat``'s fixed-seed sweep);
    then tear its fixtures down."""
    _, qual, cid = _split(scenario)
    fn, cls = _target(mod, qual)
    owner = cls() if cls is not None else None

    def bound(f):
        return f if owner is None else types.MethodType(f, owner)

    kwargs = dict(_parametrize(fn))[cid]
    inner = _inner(fn)
    drawn = set() if inner is None else (
        set(inspect.signature(bound(inner)).parameters)
        - set(inspect.signature(bound(fn)).parameters))
    by_seed = drawn == {"seed"}
    teardowns = []
    try:
        for param in inspect.signature(bound(fn)).parameters:
            if param not in kwargs:
                kwargs[param] = _fixture(mod, param, given or {}, teardowns)
        if not by_seed:
            return bound(fn)(**kwargs)
        for seed in PROPERTY_SEEDS:
            bound(inner)(seed=seed, **kwargs)
    finally:
        for teardown in reversed(teardowns):
            teardown()


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
        # threads alive before the scenario (a server's handler thread an
        # earlier scenario's stream left polling its own platform) are not
        # the scenario's: their calls go unrecorded
        self._foreign = set(threading.enumerate()) - {threading.current_thread()}
        for mod, cls in SURFACES:
            klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)
            for verb, fn in list(vars(klass).items()):
                if not verb.startswith("_") and inspect.isfunction(fn):
                    monkeypatch.setattr(klass, verb, self._verb(cls, verb, fn))
        handler = importlib.import_module(f"{pkg}.api.http")._Handler
        monkeypatch.setattr(handler, "_send_json", self._response(handler._send_json))
        fed = importlib.import_module(f"{pkg}.api.federation").Federation
        plat = importlib.import_module(f"{pkg}.core.platform").FfDLPlatform
        monkeypatch.setattr(fed, "__init__", self._built(fed.__init__, self.federations))
        monkeypatch.setattr(plat, "__init__", self._built(plat.__init__, self.platforms))

    def _verb(self, cls, verb, fn):
        log, foreign = self.wire, self._foreign

        @functools.wraps(fn)  # the verb's signature stays inspectable
        def call(obj, *args, **kwargs):
            if threading.current_thread() in foreign:
                return fn(obj, *args, **kwargs)
            try:
                out = fn(obj, *args, **kwargs)
            except Exception as e:
                log.append((cls, verb, wire(args), wire(kwargs), wire(e)))
                raise
            log.append((cls, verb, wire(args), wire(kwargs), wire(out)))
            return out
        return call

    def _response(self, send):
        """The HTTP server's JSON responses: the request line, the status
        code, the headers the handler adds and the body."""
        log, foreign = self.wire, self._foreign

        def sent(handler, status, payload, extra_headers=None):
            if threading.current_thread() not in foreign:
                log.append(("HTTP", f"{handler.command} {handler.path}", [status],
                            wire(extra_headers or {}), wire(payload)))
            return send(handler, status, payload, extra_headers)
        return sent

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


def _polled(entry, ticked=()) -> bool:
    """A long-poll or stream read (a ``wait_ms`` argument), or a verb whose
    answer carries a ticker thread's progress (``"Surface.verb"`` in
    ``ticked``): what it saw, and how often it ran, depend on when."""
    return "wait_ms" in entry[3] or f"{entry[0]}.{entry[1]}" in ticked


def _timeless(entry, ticked=()):
    """A wire entry without what the wall clock decides: a polled read as
    its surface and verb alone, a token bucket's answer without its wait,
    a 429 without its retry-after."""
    cls, verb, args, kwargs, out = entry
    if _polled(entry, ticked):
        return repr((cls, verb))
    if cls == "TokenBucket":
        out = out[0]
    if isinstance(out, dict) and out.get("error") == "RATE_LIMITED":
        out = {"error": "RATE_LIMITED"}
    return repr((cls, verb, args, kwargs, out))


def _records(platform: dict) -> dict:
    """A platform's job records: a job that ended, without the times of its
    status changes; one still running (where a ticker thread left it), by
    its id alone."""
    ended = {s.value for s in importlib.import_module("repro_torch.core.types").TERMINAL}
    return {job: [status, [h[1:] for h in history], *rest] if status in ended else None
            for job, (status, history, *rest) in platform["records"].items()}


def mirror(scenario: str, monkeypatch, capsys=None, order: str = "strict", ticked=(),
           tmp_path=None):
    """Run ``scenario`` on the reference, then on the port, each under a
    recorder, and hold the port's trace to the reference's.

    ``order`` says how, for a scenario whose threads (a ticker, concurrent
    clients, an SSE stream's polls) or wall clock (a token bucket's refill)
    make the trace differ from run to run on one package alone:

      * ``"strict"``: every wire entry in call order, and each platform's
        bus, journal and records and each federation's blocks in full;
      * ``"multiset"``: the verbs' entries as a multiset, each without
        what the wall clock decides (``_timeless``; long-poll and stream
        reads as a set of verbs), each platform's job records
        (``_records``: those that ended without their times), each
        federation's shards and tenants; the HTTP responses, which carry
        the same answers, are left out;
      * ``"set"``: the same, the verbs' entries as a set: where a token
        bucket's refill decides how many calls pass, the count of each
        entry is the clock's.

    ``ticked`` names the verbs (``"Surface.verb"``) the scenario calls
    while a ticker thread runs whose answers carry the ticker's progress (a
    loop of its own polling a migration or a rollout, the rollout's start
    with the operator's tick count): outside ``"strict"`` they compare as
    the long-poll reads do.

    ``capsys`` is pytest's, for a scenario that reads its own output;
    ``tmp_path`` is pytest's too, and each side gets a directory of its
    own under it."""
    stem = _split(scenario)[0]
    traces = {}
    for side, pkg in (("reference", "repro"), ("port", "repro_torch")):
        mod, _ = load(stem, port=side == "port")
        given = {"capsys": capsys}
        if tmp_path is not None:
            given["tmp_path"] = tmp_path / side
            given["tmp_path"].mkdir()
        if capsys is not None:
            capsys.readouterr()
        with monkeypatch.context() as m:
            rec = Recorder(pkg, m)
            run(mod, scenario, given)
            traces[side] = rec.observed()
    ref, port = traces["reference"], traces["port"]
    for key in ("platforms", "federations"):
        assert len(port[key]) == len(ref[key]), key
    if order == "strict":
        assert len(port["wire"]) == len(ref["wire"])
        for i, (a, b) in enumerate(zip(ref["wire"], port["wire"])):
            assert b == a, ("wire", i)
        for key in ("platforms", "federations"):
            for i, (a, b) in enumerate(zip(ref[key], port[key])):
                for part in a:
                    assert b[part] == a[part], (key, i, part)
        return
    assert order in ("multiset", "set"), order
    bag = collections.Counter if order == "multiset" else set
    verbs = {side: [e for e in t["wire"] if e[0] != "HTTP"] for side, t in traces.items()}
    for polled in (True, False):
        a = [_timeless(e, ticked) for e in verbs["reference"] if _polled(e, ticked) == polled]
        b = [_timeless(e, ticked) for e in verbs["port"] if _polled(e, ticked) == polled]
        assert (set if polled else bag)(b) == (set if polled else bag)(a), ("wire", polled)
    for i, (a, b) in enumerate(zip(ref["platforms"], port["platforms"])):
        assert _records(b) == _records(a), ("platforms", i, "records")
    for i, (a, b) in enumerate(zip(ref["federations"], port["federations"])):
        for part in ("shards", "tenants"):
            assert b[part] == a[part], ("federations", i, part)


def waiting(stem: str) -> list:
    """The scenarios of ``stem`` that reach a name the port does not
    define (the reference's static analyzers)."""
    mod, unbound = load(stem, port=True)
    return sorted(s for s in scenarios(stem)
                  if reaches(_target(mod, _split(s)[1])[0], unbound, mod))


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module's real jobs: their tiny steps are
    many small ops, which a thread team per op slows many-fold when the
    test workers already hold every core. A test file imports it to use
    it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def port_witness(request):
    """The port's lock-order witness (``repro_torch.analysis.witness``) on
    the port's ``RWLock`` for a parity module: a module that imports this
    fixture has every acquisition of the port's shard locks recorded, and
    the graph must be acyclic at the module's end (the reference's
    conftest does the same for its own lock after test_federation,
    test_admin_plane and test_faults)."""
    from repro_torch.analysis.witness import witness
    witness.install()
    try:
        yield witness
        witness.assert_acyclic(context=request.module.__name__)
    finally:
        witness.uninstall()
