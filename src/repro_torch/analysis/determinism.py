"""DET-AMBIENT: no ambient clock or unseeded RNG in platform code (the
port's copy of ``src/repro/analysis/determinism.py``; its scope and
``DET_ALLOWLIST`` name the port's own files, under ``src/repro_torch/``, and
a path outside that package is a fixture tree).

The simulated platform is deterministic by construction: every tick,
breaker, fault plan, and chaos schedule takes an explicit clock hook or
a seeded RNG. One stray ``time.time()`` or ``random.random()`` makes a
failing chaos campaign unreproducible — the worst possible property for
a platform whose whole test strategy is replaying seeds.

Checked subtree: ``core``, ``api``, ``obs``, ``workloads`` (analysis
tooling and the storage/cluster simulation layers below ``core`` keep
their own rules). Banned on sight:

* ambient clock reads: ``time.time``/``monotonic``/``perf_counter``
  (and ``_ns`` variants), ``time.sleep``, ``datetime.now``/``utcnow``
* module-level RNG: any ``random.*`` call except a *seeded*
  ``random.Random(seed)`` construction
* numpy global RNG: any ``np.random.*`` except a seeded
  ``np.random.default_rng(seed)`` / ``np.random.SeedSequence(...)``

``DET_ALLOWLIST`` exempts whole files that *are* the clock/timing plane,
each with a reason (rendered in docs/architecture.md). Everything else
must thread ``now``/``clock``/seeds explicitly.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Finding, dotted_name, scope_of

#: Only these subpackages of src/repro_torch are in scope.
_SCOPE_PREFIXES = (
    "src/repro_torch/core/",
    "src/repro_torch/api/",
    "src/repro_torch/obs/",
    "src/repro_torch/workloads/",
)

#: Whole-file exemptions: path -> reason (docs/architecture.md lists
#: these; a file that stops existing should be pruned here).
DET_ALLOWLIST = {
    "src/repro_torch/core/faults.py":
        "IS the clock/deadline plane: deadline_scope and ShardBreaker "
        "own the monotonic-clock hooks everything else injects",
    "src/repro_torch/api/http.py":
        "wall-clock edge: SSE heartbeat pacing and per-request latency "
        "timing are real-time observability, not simulated state",
    "src/repro_torch/api/gateway.py":
        "wall-clock edge: long-poll parking (time.sleep) happens outside "
        "shard locks and never influences simulated state",
    "src/repro_torch/api/client.py":
        "client-side retry backoff sleeps; RetryPolicy jitter is a "
        "seeded random.Random(seed) and stays reproducible",
    "src/repro_torch/api/cli.py":
        "operator-facing CLI: startup polling and timeouts are real "
        "time by definition",
}

_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.sleep",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

#: Seeded constructions allowed even under the RNG prefixes, provided
#: they carry at least one argument (the seed).
_SEEDED_CTORS = {
    "random.Random",
    "np.random.default_rng", "numpy.random.default_rng",
    "np.random.SeedSequence", "numpy.random.SeedSequence",
    "np.random.Generator", "numpy.random.Generator",
}

_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")


def _in_scope(path: str) -> bool:
    if path.startswith("src/repro_torch/"):
        return path.startswith(_SCOPE_PREFIXES)
    return True  # fixture trees: analyze everything handed to us


def _violation(call: ast.Call):
    """Return (label, why) if this call is ambient, else None."""
    dn = dotted_name(call.func)
    if not dn:
        return None
    if dn in _CLOCK_CALLS:
        return dn, "ambient clock — inject a clock hook or `now` param"
    if dn in _SEEDED_CTORS:
        if call.args or call.keywords:
            return None
        return dn, "unseeded RNG construction — pass an explicit seed"
    if dn.startswith(_RNG_PREFIXES):
        return dn, "module-level RNG — construct a seeded generator"
    return None


def check_determinism(sources) -> list:
    findings = []
    for src in sources:
        if not _in_scope(src.path):
            continue
        if src.path in DET_ALLOWLIST:
            continue
        for call in ast.walk(src.tree):
            if not isinstance(call, ast.Call):
                continue
            hit = _violation(call)
            if hit is None:
                continue
            label, why = hit
            findings.append(Finding(
                check="DET-AMBIENT",
                path=src.path,
                line=call.lineno,
                scope=scope_of(call),
                message=f"`{label}`: {why}",
                detail=label,
            ))
    return findings
