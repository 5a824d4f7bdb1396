"""The port's fault plane, deadlines, shard breakers and client retries
(``repro_torch.core.faults``, ``repro_torch.api.client``) against the
reference's on the CPU.

Every scenario of tests/test_faults.py (its test classes' methods included)
runs on both packages from the same seed through ``tests/_torch_mirror.py``
and must leave the same trace: the wire responses of every gateway verb,
each platform's event bus, journal and job records, and each federation's
migrations, tenants, workloads and journals. test_faults is one of the
three modules after which the reference's conftest asserts its lock-order
witness acyclic; the port's witness (``_torch_mirror.port_witness``) is
installed on the port's ``RWLock`` here and asserted acyclic at the end.
"""

import pytest

import _torch_mirror as mirror
from _torch_mirror import port_witness  # noqa: F401  (module fixture)

MODULES = ("test_faults",)
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem)]


def test_no_scenario_waits():
    assert [s for stem in MODULES for s in mirror.waiting(stem)] == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys):
    mirror.mirror(scenario, monkeypatch, capsys)


def test_port_witness_records_the_port_shard_locks(port_witness):  # noqa: F811
    """The module's witness is hooked to the port's RWLock: a federation's
    tick takes every shard's write lock through it."""
    from repro_torch.api import Federation
    before = port_witness.acquisitions
    Federation(n_shards=2, seed=0).tick()
    assert port_witness.acquisitions >= before + 2
    port_witness.assert_acyclic(context="a port federation's tick")
