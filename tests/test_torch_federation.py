"""The port's Federation and autonomous operator
(``repro_torch.api.federation``, ``repro_torch.obs.operator``,
``repro_torch.api.ops``) against the reference's on the CPU.

Every scenario of tests/test_federation.py and tests/test_operator.py runs
on both packages from the same seed through ``tests/_torch_mirror.py`` and
must leave the same trace: the wire responses of every gateway verb, each
shard's event bus, journal and job records, and each federation's
migrations, tenants, workloads, the reconciler's decision journal and the
operator's status and decision journal.

Three scenarios reach the port's HTTP transport and CLI. One compares in
call order (test_federation::test_v1_contract_over_http_against_four_shards);
two make their trace differ from run to run on one package alone and
compare as ``_torch_mirror.mirror``'s ``order`` and ``ticked`` say,
besides their own assertions:
  * test_federation::test_cli_logs_follow_streams_to_completion, as a
    multiset: ``ffdl logs --follow`` polls a stream while a ticker thread
    runs the federation;
  * test_operator::test_operator_surface_over_http, as a multiset: it
    starts a rollout (``start_rollout``, whose answer carries the
    operator's tick count) and polls it (``operator_status``) in a loop of
    its own while a ticker thread runs.

Then the port-side parameter: ``device`` reaches every shard, the ones
the operator's scale-up mints included.

The port's lock-order witness (``_torch_mirror.port_witness``) records
every acquisition of the port's shard locks in this module and must find
the graph acyclic at its end, as the reference's conftest asserts of its
own after the module this file mirrors.
"""

import pytest

import _torch_mirror as mirror
from _torch_mirror import port_witness  # noqa: F401  (module fixture)
from repro_torch.api import Federation
from repro_torch.api.ops import install_operator

MODULES = ("test_federation", "test_operator")
ORDER = {"test_federation::test_cli_logs_follow_streams_to_completion": ("multiset", []),
         "test_operator::test_operator_surface_over_http": (
             "multiset", ["AdminGateway.operator_status", "AdminGateway.start_rollout"])}
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem)]


def test_waiting_scenarios_are_exactly_those_that_reach_http_or_the_cli():
    assert [s for stem in MODULES for s in mirror.waiting(stem)] == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys):
    mirror.mirror(scenario, monkeypatch, capsys, *ORDER.get(scenario, ("strict", [])))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_reaches_every_shard_and_added_ones(device):
    fed = Federation(n_shards=2, n_hosts=1, chips_per_host=4, device=device)
    op = install_operator(fed)
    assert op is fed.operator
    fed.add_shard()
    assert fed.device == device
    assert [p.device for p in fed.shards] == [device] * 3
    assert [p.backend.shard_id for p in fed.shards] == ["shard-0", "shard-1", "shard-2"]
