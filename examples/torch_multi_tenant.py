"""Multi-tenant scheduling demo on the PyTorch port: quotas, opportunistic
over-quota admission, reclamation preemption, PACK packing (FfDL §3.4-3.6)
— driven through the v1 API tier (§3.2): per-tenant keys, typed envelopes,
and cross-tenant isolation enforced by the gateway.

    PYTHONPATH=src python examples/torch_multi_tenant.py                 # in-process
    PYTHONPATH=src python examples/torch_multi_tenant.py --http          # over the wire
    PYTHONPATH=src python examples/torch_multi_tenant.py --device cpu [--http]

The port's copy of examples/multi_tenant.py: the same flow and prints
through ``repro_torch``'s own ``FfDLPlatform``, ``ApiClient`` and, with
``--http``, its ``ApiHttpServer`` and ``HttpTransport`` on a live local
server. The platform's real jobs would train on ``--device`` (the CUDA
card by default; without one it raises, and never falls back to the CPU);
this demo's jobs are simulated. ``main`` asserts that every job
COMPLETED and returns ``{"statuses": {job: final status}}``.
"""

import argparse

from repro_torch.api import (
    ApiClient,
    ApiError,
    ApiHttpServer,
    ErrorCode,
    HttpTransport,
    RateLimitConfig,
)
from repro_torch.core import FfDLPlatform, JobManifest
from repro_torch.launch.serve import resolve_device


def banner(s):
    print(f"\n=== {s} " + "=" * max(0, 60 - len(s)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--http", action="store_true",
                    help="drive the demo over a live local HTTP server")
    ap.add_argument("--device", default="cuda",
                    help="where real jobs train (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    p = FfDLPlatform(n_hosts=8, chips_per_host=4, placement="pack",
                     device=args.device)  # 32 chips
    p.admission.register_tenant("vision-team", quota_chips=16)
    p.admission.register_tenant("nlp-team", quota_chips=12)
    p.admission.register_tenant("interns", quota_chips=4, tier="free")
    # each tenant talks to the API tier with its own key
    vision_key = p.auth.issue_key("vision-team")
    nlp_key = p.auth.issue_key("nlp-team")

    server = None
    if args.http:
        server = ApiHttpServer(p, rate_limit=RateLimitConfig(
            rate=500.0, burst=200)).start()
        transport = HttpTransport(server.base_url)
        print(f"(speaking JSON over HTTP to {server.base_url})")
    else:
        transport = p.api
    vision = ApiClient(transport, vision_key)
    nlp = ApiClient(transport, nlp_key)

    def advance(sim_seconds):
        # the sim is single-threaded: tick under the server's lock so HTTP
        # handler threads never interleave with the engine. Never hold the
        # lock while issuing client calls (the handler needs it).
        if server is not None:
            with server.lock:
                p.run_for(sim_seconds)
        else:
            p.run_for(sim_seconds)

    try:
        banner("vision-team fills its quota AND borrows idle capacity")
        v = [vision.submit(
                JobManifest(name=f"vision-{i}", tenant="vision-team",
                            n_learners=2, chips_per_learner=4,
                            sim_duration=600),
                idempotency_key=f"vision-{i}")
             for i in range(3)]  # 24 chips > 16 quota: third is opportunistic
        advance(90)
        for j in v:
            print(f"  {j}: {vision.status(j).value}")

        banner("tenant isolation: nlp-team cannot touch vision-team's jobs")
        try:
            nlp.halt(v[0])
        except ApiError as e:
            assert e.code == ErrorCode.FORBIDDEN
            extra = f" (HTTP {e.details['http_status']})" if args.http else ""
            print(f"  halt({v[0]}) with nlp key -> {e.code.value}{extra}")
        dup = vision.submit_envelope(
            JobManifest(name="vision-0", tenant="vision-team",
                        n_learners=2, chips_per_learner=4,
                        sim_duration=600),
            idempotency_key="vision-0")
        print(f"  duplicate submit (same idempotency key) -> {dup.job_id} "
              f"deduplicated={dup.deduplicated}")
        print(f"  utilization: {p.cluster.utilization():.0%}  "
              f"(over-quota jobs: "
              f"{[k for k, o in p.admission.over_quota.items() if o]})")

        banner("nlp-team claims its quota -> vision's over-quota job is "
               "preempted")
        n = nlp.submit(JobManifest(name="nlp-big", tenant="nlp-team",
                                   n_learners=3, chips_per_learner=4,
                                   sim_duration=300))
        advance(240)
        for j in v:
            print(f"  {j}: {vision.status(j).value}")
        print(f"  {n}: {nlp.status(n).value}")
        preempts = p.events.of_kind("preempt")
        print(f"  preemptions: "
              f"{[(e.fields['job'], e.fields['reason']) for e in preempts]}")

        banner("PACK keeps whole hosts free for big gangs")
        frees = sorted(h.free_chips for h in p.cluster.hosts.values())
        print(f"  free chips per host: {frees}")

        banner("drain")
        # HALTED is NOT terminal here: the preempted over-quota job is
        # auto-requeued and must come back and finish
        deadline = 20000
        while deadline > 0:
            advance(200)
            deadline -= 200
            views = [vision.view(j) for j in v] + [nlp.view(n)]
            if all(s.status in ("COMPLETED", "FAILED") for s in views):
                break
        for j in v:
            print(f"  {j}: {vision.status(j).value}")
        print(f"  {n}: {nlp.status(n).value}")
        print("\nper-tenant history:")
        for t, cli in (("vision-team", vision), ("nlp-team", nlp)):
            page = cli.list_jobs(tenant=t, limit=20)
            for view in page.items:
                print(f"  {t:12s} {view.job_id} {view.status}")
        statuses = {**{j: vision.status(j).value for j in v}, n: nlp.status(n).value}
        assert set(statuses.values()) == {"COMPLETED"}, statuses
        return {"statuses": statuses}
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    main()
