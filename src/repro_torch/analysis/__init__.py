"""Invariant analyzer suite: machine-checked concurrency + contract rules
(the port's copy of ``src/repro/analysis``, run over the port's own
package, ``src/repro_torch``, against its own ``baseline.json``).

The platform rests on a set of load-bearing
conventions — per-shard RW locks acquired in a canonical order, pure
``decide()`` policy cores, seeded RNG everywhere determinism matters,
and five hand-pinned wire registries — that were enforced only by
docstrings and scattered tests. FfDL's dependability lessons (§5.6 and
the Boag et al. companion study) say exactly these conventions are where
multi-tenant platforms rot: concurrency discipline and contract drift,
not model code. This package turns the conventions into *invariants*:

  * **static checkers** (stdlib ``ast`` only, no third-party deps) run
    over ``src/repro_torch`` by ``python -m repro_torch.analysis`` / ``make lint``:

      - ``LOCK-BLOCKING`` / ``LOCK-ORDER``  (:mod:`repro_torch.analysis.locks`)
      - ``PURITY-CALL`` / ``PURITY-MUTATION`` (:mod:`repro_torch.analysis.purity`)
      - ``DET-AMBIENT``  (:mod:`repro_torch.analysis.determinism`)
      - ``REG-EVENT`` / ``REG-METRIC`` / ``REG-ROUTE``
        (:mod:`repro_torch.analysis.registry`)
      - ``DEADLINE-VERB``  (:mod:`repro_torch.analysis.deadlines`)

  * a **runtime lock-order witness** (:mod:`repro_torch.analysis.witness`)
    that instruments ``RWLock`` acquisition under pytest and the chaos
    benchmarks and asserts the observed acquisition graph is acyclic —
    catching dynamic ordering hazards the AST cannot see.

Intentional exceptions live in ``baseline.json`` next to this file;
every entry carries a ``reason`` and the CLI fails on any finding not
baselined. docs/architecture.md ("Invariants & static analysis")
documents the check table and the lock lattice; tests/test_docs_api.py
pins that section, and tests/test_analysis.py proves each check fires
on a seeded violation (tests/test_torch_analysis.py runs both on this
package too).
"""

from repro_torch.analysis.base import (
    AnalysisResult,
    Baseline,
    Finding,
    SourceFile,
    load_sources,
)
from repro_torch.analysis.deadlines import check_deadlines
from repro_torch.analysis.determinism import check_determinism
from repro_torch.analysis.locks import LOCK_LATTICE, check_locks
from repro_torch.analysis.purity import PURE_REGISTRY, check_purity
from repro_torch.analysis.registry import check_registries

# The pinned check-id vocabulary (docs/architecture.md tables these; a
# new checker must add its ids here so the docs pin catches it).
CHECK_IDS = (
    "LOCK-BLOCKING",   # blocking call while holding a shard/plane lock
    "LOCK-ORDER",      # lock acquired against the declared lattice order
    "PURITY-CALL",     # registered-pure function reaches an impure call
    "PURITY-MUTATION",  # registered-pure function mutates an input
    "DET-AMBIENT",     # ambient clock / unseeded RNG outside the allowlist
    "REG-EVENT",       # emitted event kind missing from PLATFORM_EVENT_KINDS
    "REG-METRIC",      # rendered metric family <-> METRIC_NAMES drift
    "REG-ROUTE",       # route table <-> handler table drift
    "DEADLINE-VERB",   # v1/v2 verb dispatched outside a deadline_scope
)

CHECKERS = (
    check_locks,
    check_purity,
    check_determinism,
    check_registries,
    check_deadlines,
)


def run_analysis(root=None) -> AnalysisResult:
    """Run every checker over ``src/repro_torch`` (or ``root``); returns the
    raw findings (baseline NOT yet applied — the CLI does that)."""
    sources = load_sources(root)
    findings = []
    for checker in CHECKERS:
        findings.extend(checker(sources))
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return AnalysisResult(findings=findings, files=len(sources))


__all__ = [
    "AnalysisResult",
    "Baseline",
    "CHECK_IDS",
    "CHECKERS",
    "Finding",
    "LOCK_LATTICE",
    "PURE_REGISTRY",
    "SourceFile",
    "check_deadlines",
    "check_determinism",
    "check_locks",
    "check_purity",
    "check_registries",
    "load_sources",
    "run_analysis",
]
