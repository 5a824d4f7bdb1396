"""The port's JSON-over-HTTP transport and ``ffdl`` CLI
(``repro_torch.api.http``, ``repro_torch.api.cli``) against the
reference's on the CPU.

Every scenario of tests/test_http_api.py, tests/test_sse_stream.py and
tests/test_docs_api.py runs on both packages through
``tests/_torch_mirror.py``: a real server on 127.0.0.1, the same requests,
and the same trace left by every gateway verb the handlers reach, each
platform's bus, journal and records. test_docs_api's scenarios hold the
port's route tables and ``STATUS_OF`` to the same ``docs/api.md``.

Most scenarios make their requests from one thread, one after the other:
their traces compare in call order. These do not, and compare as
``_torch_mirror.mirror`` says for ``order`` (the wire entries as a
multiset or a set, without what the wall clock decides; the job records
without their times), besides their own assertions on both sides:

  * ``multiset``: test_http_api's concurrent submits (eight client threads
    race one idempotency key); test_sse_stream's scenarios that follow a
    stream, a long-poll or the event bus while a ticker thread runs the
    platform (how many polls a stream makes, and what each sees, depends
    on when it runs against the ticks), and its heartbeat, disconnect,
    budget and stream-cap scenarios (the polls between heartbeats follow
    the wall clock);
  * ``set``: test_http_api's rate-limited flood (a token bucket's refill
    on the wall clock decides how many calls pass).

test_docs_api::test_invariants_section_in_architecture_md holds both
packages' analyzers (``repro.analysis``, ``repro_torch.analysis``) to the
same ``docs/architecture.md`` section, and no scenario waits.

Then the port-side scenarios: test_hotpath's ``wait_ms`` watch over HTTP
(its module imports the reference's benchmark oracles, which the mirror
cannot rewrite), a real tiny smollm-360m job submitted over HTTP to a
two-shard ``Federation(device="cpu")``, ending on the in-process job's
state bit for bit, and ``ffdl serve`` handing ``--device`` to the
Federation.
"""

import threading
import time

import pytest
import torch

import _torch_mirror as mirror
from _torch_mirror import one_thread  # noqa: F401 (a fixture)
from repro_torch.api import (
    ApiClient,
    ApiError,
    ApiHttpServer,
    ErrorCode,
    Federation,
    HttpTransport,
    SubmitRequest,
)
from repro_torch.api import cli
from repro_torch.api import federation as tfederation
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import FfDLPlatform, JobManifest, JobStatus
from repro_torch.data.objectstore import MountedBucket

MODULES = ("test_http_api", "test_sse_stream", "test_docs_api")
WAITING = []
ORDER = {
    "test_http_api::test_concurrent_submits_same_idempotency_key_one_job": ("multiset", []),
    "test_http_api::test_rate_limited_flood_gets_429_with_retry_after": ("set", []),
    **{f"test_sse_stream::{name}": ("multiset", []) for name in (
        "test_stream_logs_single_connection_terminal_close",
        "test_stream_logs_resume_from_last_event_id_is_exact",
        "test_stream_status_emits_changes_then_end",
        "test_idle_stream_heartbeats_at_cadence",
        "test_client_disconnect_releases_stream_slot",
        "test_stream_budget_expiry_closes_cleanly",
        "test_max_streams_cap_answers_rate_limited",
        "test_client_follow_logs_rides_sse",
        "test_client_watch_status_rides_sse_until_terminal",
        "test_client_follow_events_streams_and_resumes",
        "test_client_prefers_long_poll_when_asked",
        "test_cli_logs_follow_single_sse_connection",
        "test_cli_events_page_and_usage")},
}
SCENARIOS = [s for stem in MODULES for s in mirror.scenarios(stem) if s not in WAITING]


def test_waiting_scenarios_are_exactly_those_that_reach_the_analyzers():
    assert sorted(s for stem in MODULES for s in mirror.waiting(stem)) == sorted(WAITING)


def test_unordered_scenarios_exist():
    assert set(ORDER) <= set(SCENARIOS)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_leaves_the_same_trace_on_both_packages(scenario, monkeypatch, capsys):
    mirror.mirror(scenario, monkeypatch, capsys, *ORDER.get(scenario, ("strict", [])))


# --------------------------------------------------------------------------
# test_hotpath's watch long-poll over HTTP, on the port
# --------------------------------------------------------------------------

def sim_job(name="j", tenant="team-a", **kw):
    kw.setdefault("n_learners", 1)
    kw.setdefault("chips_per_learner", 1)
    kw.setdefault("sim_duration", 60)
    return JobManifest(name=name, tenant=tenant, **kw)


def test_watch_status_over_http():
    """The watch long-poll is part of the wire contract: wait_ms and
    last_status ride query params on GET /v1/jobs/{id} (test_hotpath's
    scenario, with its assertions)."""
    p = FfDLPlatform(n_hosts=4, chips_per_host=4)
    key = p.auth.issue_key("team-a")
    with ApiHttpServer(p) as server:
        client = ApiClient(HttpTransport(server.base_url), key)
        j = client.submit(sim_job(tenant="team-a"))
        stop = threading.Event()

        def ticker():
            while not stop.is_set():
                with server.lock:
                    p.tick()
                time.sleep(0.002)

        t = threading.Thread(target=ticker)
        t.start()
        try:
            seen = [v.status for v in client.watch_status(j, wait_ms=500)]
        finally:
            stop.set()
            t.join(10)
        # malformed last_status → 400 with the stable code, over the wire
        with pytest.raises(ApiError) as ei:
            client.transport.status(key, j, wait_ms=100, last_status="nope")
        assert ei.value.code == ErrorCode.INVALID_ARGUMENT
        assert ei.value.details.get("http_status") == 400
    assert seen[-1] == "COMPLETED"
    assert set(seen) & {"QUEUED", "DEPLOYING", "DOWNLOADING",
                        "PROCESSING", "STORING"}, seen


# --------------------------------------------------------------------------
# a real job over the wire
# --------------------------------------------------------------------------

REAL_JOB = {"n_learners": 1, "chips_per_learner": 1, "arch": "smollm-360m",
            "checkpoint_interval": 10,
            "train": {"steps": 20, "batch": 4, "seq": 64, "seed": 3}}



def final_leaves(platform, job_id):
    bucket = MountedBucket(platform.objstore, "results")
    step = ckpt.latest_step(bucket, f"{job_id}/ckpt")
    leaves, meta = ckpt.restore(bucket, f"{job_id}/ckpt", step)
    return step, leaves, meta


def test_real_job_over_http_ends_on_the_in_process_state(one_thread):
    """A tiny smollm-360m job submitted over ``POST /v1/jobs`` to a
    two-shard Federation on the CPU, followed to its end by ``ffdl logs
    --follow`` on one SSE stream while the main thread ticks: COMPLETED,
    on the final state of the same manifest submitted in-process to the
    port's FfDLPlatform, bit for bit."""
    fed = Federation(n_shards=2, n_hosts=2, chips_per_host=4, tick_period=5.0, device="cpu")
    manifest = JobManifest(name="lm-train", tenant="team-a", **REAL_JOB)
    with ApiHttpServer(fed) as server:
        transport = HttpTransport(server.base_url)
        key = fed.auth.issue_key("team-a")
        job = transport.submit(key, SubmitRequest(manifest=manifest)).job_id
        rc = {}
        follow = threading.Thread(target=lambda: rc.update(rc=cli.main(
            ["--endpoint", server.base_url, "--key", key, "logs", job, "--follow"])))
        follow.start()
        for _ in range(300):
            fed.tick()
            if transport.status(key, job).status in ("COMPLETED", "FAILED"):
                break
        follow.join(30)
        assert transport.status(key, job).status == "COMPLETED"
        assert rc == {"rc": 0} and server.streams_opened == 1
    shard = fed.router.shard_for("team-a").platform
    step, leaves, meta = final_leaves(shard, job)
    assert step == 20 and meta == {"final": True}

    p = FfDLPlatform(n_hosts=2, chips_per_host=4, device="cpu")
    j = ApiClient.for_platform(p, "team-a").submit(manifest)
    assert p.run_until_terminal([j], max_sim_s=5000)
    assert p.meta.get(j).status == JobStatus.COMPLETED
    want_step, want, _ = final_leaves(p, j)
    assert want_step == step and set(leaves) == set(want)
    for path in want:
        assert leaves[path].dtype == want[path].dtype
        assert torch.equal(leaves[path], want[path]), path


# --------------------------------------------------------------------------
# ffdl serve --device
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv,device", [([], "cuda"), (["--device", "cpu"], "cpu")])
def test_cli_serve_hands_its_device_to_the_federation(argv, device, monkeypatch, capsys):
    """``ffdl serve`` builds the port's Federation on ``--device`` (the card
    by default), listens, and stops at Ctrl-C."""
    built = []
    init = tfederation.Federation.__init__

    def recording(fed, *args, **kwargs):
        init(fed, *args, **kwargs)
        built.append(fed)

    def interrupt(fed):
        raise KeyboardInterrupt

    monkeypatch.setattr(tfederation.Federation, "__init__", recording)
    monkeypatch.setattr(tfederation.Federation, "tick", interrupt)  # Ctrl-C at the first tick
    assert cli.main(["serve", "--port", "0", "--shards", "2", "--tick-period", "0.01",
                     *argv]) == 0
    assert len(built) == 1 and built[0].device == device
    assert [p.device for p in built[0].shards] == [device] * 2
    out = capsys.readouterr().out
    assert "ffdl API server listening on http://127.0.0.1:" in out and "bye" in out
