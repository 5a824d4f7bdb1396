"""The port's v2 admin plane and rate limiting (``repro_torch.api.admin``,
``repro_torch.api.ratelimit``) against the reference's on the CPU.

Every scenario of tests/test_admin_plane.py and tests/test_ratelimit.py
runs on both packages from the same seed through ``tests/_torch_mirror.py``
and must leave the same trace: the wire responses of every gateway verb,
each platform's event bus, journal and job records, and each federation's
migrations (phases and counts), tenants, workloads and journals.

Waiting for the port's HTTP transport (ROADMAP A.19), and not run here:
  * test_admin_plane::test_admin_plane_over_http
  * test_admin_plane::test_v2_unknown_keys_are_rate_limited_before_auth
"""

import pytest

import _torch_mirror as mirror

MODULES = ("test_admin_plane", "test_ratelimit")
WAITING = ["test_admin_plane::test_admin_plane_over_http",
           "test_admin_plane::test_v2_unknown_keys_are_rate_limited_before_auth"]
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem) if s not in WAITING]


def test_waiting_scenarios_are_exactly_those_that_reach_http():
    assert sorted(s for stem in MODULES for s in mirror.waiting(stem)) == sorted(WAITING)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch):
    mirror.mirror(scenario, monkeypatch)
