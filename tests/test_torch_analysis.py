"""The port's invariant analyzers (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

Every scenario of tests/test_analysis.py runs on both packages through
``tests/_torch_mirror.py``, each checker it calls recorded: for each
seeded-violation fixture both packages' findings must be equal, field for
field (check, path, line, scope, detail, message). The port's witness
(``_torch_mirror.port_witness``) is installed on the port's ``RWLock`` for
this module, as the reference's conftest installs its own, and must be
acyclic at the end.

Then the port's own tree: ``run_analysis()`` over ``src/repro_torch`` gives
exactly what the reference's checkers find in the port's files read under
the reference's paths (one finding, baselined), and ``python -m
repro_torch.analysis`` exits 0. And the guards against a path table that
names the reference's files (a ``DET-AMBIENT`` scope or allowlist under
``src/repro/`` checks nothing, or everything, in the port; a purity entry
whose file is absent is skipped without a word): every registry entry and
allowlist key reaches a file the port's ``load_sources()`` returns, the
scope covers as many files as the reference's, and an allowlist key pointed
back at ``src/repro/`` turns up that file's findings.
"""

import os
import shutil
import subprocess
import sys

import pytest

import _torch_mirror as mirror
from _torch_mirror import port_witness  # noqa: F401  (module fixture)
from repro import analysis as ref_analysis
from repro.analysis import determinism as ref_determinism
from repro.analysis.base import SourceFile as RefSourceFile
from repro_torch import analysis
from repro_torch.analysis import determinism, purity
from repro_torch.analysis.base import REPO_ROOT, Baseline, load_sources

STEM = "test_analysis"
SCENARIOS = mirror.scenarios(STEM)
CHECKERS = ("check_locks", "check_purity", "check_determinism", "check_registries",
            "check_deadlines")
PORT, REF = "src/repro_torch/", "src/repro/"


def as_tuple(f):
    return (f.check, f.path, f.line, f.scope, f.detail, f.message)


def findings_of(side, scenario, tmp_path):
    """Run ``scenario`` on one side with every checker the test module
    calls recorded; returns [(checker, [finding tuples])]."""
    mod, _ = mirror.load(STEM, port=side == "port")
    log = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append((name, [as_tuple(f) for f in out]))
            return out
        return call

    for name in CHECKERS:
        setattr(mod, name, recorded(name, getattr(mod, name)))
    root = tmp_path / side
    root.mkdir()
    mirror.run(mod, scenario, {"tmp_path": root})
    return log


def test_no_scenario_waits():
    assert mirror.waiting(STEM) == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_finds_the_same_on_both_packages(scenario, tmp_path):
    ref = findings_of("reference", scenario, tmp_path)
    port = findings_of("port", scenario, tmp_path)
    assert port == ref


def test_seeded_fixtures_find_every_check_id(tmp_path):
    """The comparison above is not empty: the scenarios record findings of
    every check id."""
    seen = set()
    for i, scenario in enumerate(SCENARIOS):
        root = tmp_path / str(i)
        root.mkdir()
        for _name, found in findings_of("port", scenario, root):
            seen |= {f[0] for f in found}
    assert seen == set(analysis.CHECK_IDS)


# --------------------------------------------------------------------------
# the port's own tree
# --------------------------------------------------------------------------

def ported(src):
    """A port source file as the reference's checkers read it: under the
    reference's path."""
    return RefSourceFile(path=REF + src.path[len(PORT):], text=src.text, tree=src.tree)


def test_run_analysis_equals_the_reference_checkers_on_the_port():
    sources = load_sources()
    assert sources and all(s.path.startswith(PORT) for s in sources)
    want = []
    for checker in ref_analysis.CHECKERS:
        want.extend(checker([ported(s) for s in sources]))
    want = sorted((f.check, PORT + f.path[len(REF):], f.line, f.scope, f.detail, f.message)
                  for f in want)
    result = analysis.run_analysis()
    assert result.files == len(sources)
    assert sorted(as_tuple(f) for f in result.findings) == want
    baseline = Baseline.load()
    new, old = result.split(baseline)
    assert new == [] and baseline.unjustified() == [] and baseline.stale() == []
    assert [f.key for f in old] == [
        "LOCK-ORDER:src/repro_torch/api/admin.py:AdminPlane._cutover:second.write_locked"]


def test_cli_exits_zero_over_the_port():
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new finding(s), 1 baselined, 0 stale" in out.stdout


def test_cli_fails_on_a_finding_outside_the_baseline(tmp_path):
    (tmp_path / "svc.py").write_text("import time\n\n\ndef tick():\n    return time.time()\n")
    from repro_torch.analysis.__main__ import main
    assert main(["--root", str(tmp_path), "--baseline", str(tmp_path / "none.json"),
                 "-q"]) == 1


def test_pure_registry_reaches_the_port_files():
    by_path = {s.path: s for s in load_sources()}
    assert len(purity.PURE_REGISTRY) == len(ref_analysis.PURE_REGISTRY) == 8
    for (path, qualname), (ref_path, ref_qualname) in zip(purity.PURE_REGISTRY,
                                                           ref_analysis.PURE_REGISTRY):
        assert path == PORT + ref_path[len(REF):] and qualname == ref_qualname
        assert path in by_path, path
        assert qualname in purity._index_file(by_path[path]), (path, qualname)


def test_det_allowlist_keys_exist_in_scope():
    paths = {s.path for s in load_sources()}
    assert [PORT + k[len(REF):] for k in ref_determinism.DET_ALLOWLIST] == \
        list(determinism.DET_ALLOWLIST)
    for key in determinism.DET_ALLOWLIST:
        assert (REPO_ROOT / key).is_file() and key in paths, key
        assert determinism._in_scope(key), key


def test_det_scope_covers_as_many_files_as_the_reference():
    port = [s.path for s in load_sources() if determinism._in_scope(s.path)]
    ref = [s.path for s in ref_analysis.load_sources() if ref_determinism._in_scope(s.path)]
    assert len(port) == len(ref) > 0
    assert {p[len(PORT):] for p in port} == {p[len(REF):] for p in ref}


def test_allowlist_key_pointed_at_the_reference_turns_up_findings(tmp_path, monkeypatch):
    """A copy of the port's tree, checked with one allowlist key naming the
    reference's file instead of the port's: that file's ambient calls come
    back, and only those."""
    for src in load_sources():
        dst = tmp_path / src.path
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO_ROOT / src.path, dst)
    copy = load_sources(tmp_path)
    assert determinism.check_determinism(copy) == []
    key = PORT + "api/gateway.py"
    table = {(REF + k[len(PORT):] if k == key else k): v
             for k, v in determinism.DET_ALLOWLIST.items()}
    monkeypatch.setattr(determinism, "DET_ALLOWLIST", table)
    found = determinism.check_determinism(copy)
    assert found and {f.path for f in found} == {key}
    assert {f.detail for f in found} == {"time.monotonic", "time.sleep"}


def test_witness_is_the_port_own():
    from repro.analysis.witness import witness as ref_witness
    from repro_torch.analysis.witness import LockOrderWitness, witness
    from repro_torch.api.backend import RWLock
    assert isinstance(witness, LockOrderWitness) and witness is not ref_witness
    assert witness._installed is not None and witness._installed[0] is RWLock
