"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device
count (1 CPU device); only dryrun.py forces 512 host devices."""

import jax
import pytest

from repro.analysis.witness import witness


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
    # Per-test wall cap so a parked long-poll/SSE wait can never hang the
    # suite. Gated on the pytest-timeout plugin actually being installed
    # (it is in requirements-dev.txt / CI; local runs without it keep
    # working, just uncapped). An explicit --timeout on the command line
    # wins over this default.
    if config.pluginmanager.hasplugin("timeout"):
        if not getattr(config.option, "timeout", None):
            config.option.timeout = 120.0
            config.option.timeout_method = "thread"
    # Runtime lock-order witness (repro.analysis.witness): every RWLock
    # acquisition in the whole run feeds the acquisition graph, so a
    # cross-thread ABBA hazard anywhere in the suite is recordable even
    # if the deadlock schedule never fires.
    witness.install()


def pytest_unconfigure(config):
    witness.uninstall()


# The concurrency-heavy modules after which the witnessed acquisition
# graph must be acyclic (the ISSUE's federation / admin-rebalance /
# faults trio). The graph is cumulative across the run — asserting after
# each of these also covers everything that ran before it.
_WITNESS_CHECKED_MODULES = {
    "test_federation", "test_admin_plane", "test_faults",
}


@pytest.fixture(autouse=True, scope="module")
def _lock_order_witness(request):
    yield
    if request.module.__name__ in _WITNESS_CHECKED_MODULES:
        witness.assert_acyclic(context=request.module.__name__)
