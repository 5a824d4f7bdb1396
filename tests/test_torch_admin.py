"""The port's v2 admin plane and rate limiting (``repro_torch.api.admin``,
``repro_torch.api.ratelimit``) against the reference's on the CPU.

Every scenario of tests/test_admin_plane.py and tests/test_ratelimit.py
runs on both packages from the same seed through ``tests/_torch_mirror.py``
and must leave the same trace: the wire responses of every gateway verb,
each platform's event bus, journal and job records, and each federation's
migrations (phases and counts), tenants, workloads and journals.

Two scenarios reach the port's HTTP transport and make their trace differ
from run to run on one package alone; they compare as
``_torch_mirror.mirror``'s ``order`` and ``ticked`` say, besides their own
assertions:
  * test_admin_plane::test_admin_plane_over_http, as a multiset: it starts
    a migration and polls it in a loop of its own while a ticker thread
    runs the federation, then reads the tenant, the job and the migrations,
    whose answers carry the ticks' progress (the job's status, the
    migration's times);
  * test_admin_plane::test_v2_unknown_keys_are_rate_limited_before_auth,
    as a set: a token bucket's refill on the wall clock decides how many
    calls pass.

The port's lock-order witness (``_torch_mirror.port_witness``) records
every acquisition of the port's shard locks in this module and must find
the graph acyclic at its end, as the reference's conftest asserts of its
own after the module this file mirrors.
"""

import pytest

import _torch_mirror as mirror
from _torch_mirror import port_witness  # noqa: F401  (module fixture)

MODULES = ("test_admin_plane", "test_ratelimit")
ORDER = {"test_admin_plane::test_admin_plane_over_http": (
    "multiset", ["AdminGateway.start_migration", "AdminGateway.get_migration",
                 "AdminGateway.get_tenant", "AdminGateway.list_migrations",
                 "ApiGateway.status"]),
         "test_admin_plane::test_v2_unknown_keys_are_rate_limited_before_auth": ("set", [])}
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem)]


def test_waiting_scenarios_are_exactly_those_that_reach_http():
    assert [s for stem in MODULES for s in mirror.waiting(stem)] == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys):
    mirror.mirror(scenario, monkeypatch, capsys, *ORDER.get(scenario, ("strict", [])))
