"""The port's v1 gateway, observability plane, indexed hot paths, etcd
model and object store (``repro_torch.api.gateway``, ``repro_torch.obs``,
``repro_torch.core.metastore``, ``repro_torch.core.kvstore``,
``repro_torch.data``) against the reference's on the CPU.

Every scenario of tests/test_api_gateway.py, tests/test_obs_plane.py,
tests/test_hotpath.py, tests/test_kvstore.py and
tests/test_data_objectstore.py runs on both packages from the same seed
through ``tests/_torch_mirror.py`` and must leave the same trace: the wire
responses of every gateway verb, each platform's event bus, journal and
job records. Their property tests draw the same examples on both sides
(``_propstrat``'s fixed-seed sweep). test_hotpath's oracles come from the
reference's ``benchmarks/hotpath.py`` on both sides: the port's indexed
pages and scheduler are held to the same brute-force baselines.

Three scenarios make their trace differ from run to run on one package
alone, and compare as ``_torch_mirror.mirror``'s ``order`` says, besides
their own assertions:
  * test_obs_plane::test_throttle_meters_tenant_and_emits_event, as a set:
    a token bucket's refill on the wall clock decides its retry-after, and
    on a slow run whether the second call passes;
  * test_hotpath::test_watch_status_client_streams_until_terminal and
    test_hotpath::test_watch_status_over_http (the same over a real
    server), as multisets: each long-polls a job's status while a ticker
    thread runs the platform, and how many polls it makes depends on when
    they run against the ticks.
"""

import pytest

import _torch_mirror as mirror

MODULES = ("test_api_gateway", "test_obs_plane", "test_hotpath", "test_kvstore",
           "test_data_objectstore")
ORDER = {"test_obs_plane::test_throttle_meters_tenant_and_emits_event": ("set", []),
         "test_hotpath::test_watch_status_client_streams_until_terminal": ("multiset", []),
         "test_hotpath::test_watch_status_over_http": ("multiset", [])}
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem)]


def test_no_scenario_waits():
    assert [s for stem in MODULES for s in mirror.waiting(stem)] == []


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys,
                                                         tmp_path):
    mirror.mirror(scenario, monkeypatch, capsys, *ORDER.get(scenario, ("strict", [])),
                  tmp_path=tmp_path)


def test_unordered_scenarios_exist():
    assert set(ORDER) <= set(SCENARIOS)
