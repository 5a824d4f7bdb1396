"""``ffdl`` — the thin CLI for the v1 API tier.

The port's copy of the reference's ``repro/api/cli.py``; where it differs,
``serve`` takes ``--device`` and passes it to the port's ``Federation``.

Speaks ONLY the wire protocol (JSON over HTTP via
:class:`~repro_torch.api.http.HttpTransport`); it has no in-process shortcut to
the platform, so everything it can do, any HTTP client can do.

    python -m repro_torch.api.cli serve --port 8084 --tenant demo --rate 200
    export FFDL_ENDPOINT=http://127.0.0.1:8084 FFDL_API_KEY=ffdl-...
    python -m repro_torch.api.cli submit --name train1 --learners 2 --chips 2 \
        --sim-duration 120 --idempotency-key train1-try1
    python -m repro_torch.api.cli list --limit 10
    python -m repro_torch.api.cli status job-00001 --watch
    python -m repro_torch.api.cli logs job-00001 --follow
    python -m repro_torch.api.cli halt job-00001 && python -m repro_torch.api.cli resume job-00001
    python -m repro_torch.api.cli events --follow --kind job_completed
    python -m repro_torch.api.cli usage
    # v2 admin plane (use the operator key `serve` prints):
    python -m repro_torch.api.cli admin shards
    python -m repro_torch.api.cli admin create-tenant team-a --quota 8 --shard shard-0
    python -m repro_torch.api.cli admin migrate team-a shard-1 --wait
    python -m repro_torch.api.cli admin drain shard-0
    # autonomous operator (requires `serve --operator`):
    python -m repro_torch.api.cli admin operator
    python -m repro_torch.api.cli admin rollout v1 --wait

``serve`` boots a local simulated platform — optionally federated over
``--shards`` independent backend shards — prints one API key per
``--tenant`` (with its shard placement), and ticks the simulation in the
foreground so submitted jobs actually run. A job whose manifest names an
``arch`` trains for real on ``--device``: the card by default, as at every
entry point of the port, or ``--device cpu``. ``logs --follow``,
``status --watch`` and ``events --follow`` each hold ONE SSE connection
(heartbeats, exact resume via ``Last-Event-ID``); ``--long-poll`` forces
the request-train fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.api.http import ApiHttpServer, HttpTransport
from repro_torch.api.ratelimit import RateLimitConfig
from repro_torch.api.types import ApiError
from repro_torch.core.types import JobManifest

DEFAULT_ENDPOINT = "http://127.0.0.1:8084"


def _transport(args) -> HttpTransport:
    return HttpTransport(args.endpoint)


def _key(args) -> str:
    if not args.key:
        sys.exit("error: no API key (pass --key or set FFDL_API_KEY)")
    return args.key


def _print_json(obj):
    print(json.dumps(obj, indent=2, default=str))


def _view_row(v) -> str:
    return (f"{v.job_id:12s} {v.tenant:12s} {v.status:12s} "
            f"step={v.progress_step:<6d} {v.name}")


# --------------------------------------------------------------------------
# Subcommands
# --------------------------------------------------------------------------

def cmd_serve(args) -> int:
    from repro_torch.api.federation import Federation
    fed = Federation(n_shards=args.shards, n_hosts=args.hosts,
                     chips_per_host=args.chips_per_host, device=args.device)
    if getattr(args, "operator", False):
        from repro_torch.api.ops import install_operator
        install_operator(fed)
        print("autonomous operator: ON (autoscaling, hot-tenant isolation, "
              "rolling upgrades via /v2/admin/operator)")
    rate = None
    if args.rate:
        rate = RateLimitConfig(rate=args.rate, burst=args.burst,
                               max_inflight=args.max_inflight)
    server = ApiHttpServer(fed, host=args.host, port=args.port,
                           rate_limit=rate)
    print(f"ffdl API server listening on {server.base_url} "
          f"({args.shards} shard{'s' if args.shards != 1 else ''})")
    for tenant in args.tenant or ["demo"]:
        print(f"  tenant {tenant!r} -> {fed.shard_of(tenant)}: API key "
              f"{fed.auth.issue_key(tenant)}")
    print(f"  operator (v2 admin plane) API key "
          f"{fed.auth.issue_admin_key()}")
    limited = f"rate={args.rate}/s burst={args.burst}" if rate else "off"
    print(f"  rate limiting: {limited}")
    print("ticking simulation; Ctrl-C to stop")
    with server:
        try:
            while True:
                time.sleep(args.tick_period)
                # per-shard write locks: reads on other shards keep flowing
                fed.tick()
        except KeyboardInterrupt:
            print("\nbye")
    return 0


def cmd_health(args) -> int:
    out = _transport(args).health()
    _print_json(out)
    return 0 if out.get("status") == "ok" else 1


def cmd_submit(args) -> int:
    manifest = JobManifest(
        name=args.name, tenant=args.tenant, n_learners=args.learners,
        chips_per_learner=args.chips, sim_duration=args.sim_duration,
        **(json.loads(args.extra) if args.extra else {}))
    from repro_torch.api.types import SubmitRequest
    resp = _transport(args).submit(
        _key(args), SubmitRequest(manifest=manifest,
                                  idempotency_key=args.idempotency_key))
    dedup = " (deduplicated)" if resp.deduplicated else ""
    print(f"{resp.job_id}{dedup}")
    return 0


def cmd_list(args) -> int:
    t = _transport(args)
    cursor = args.cursor
    while True:
        page = t.list_jobs(_key(args), tenant=args.tenant,
                           status=args.status, cursor=cursor,
                           limit=args.limit)
        for v in page.items:
            print(_view_row(v))
        cursor = page.next_cursor
        if cursor is None or not args.all:
            if cursor is not None:
                print(f"# next cursor: {cursor}  (pass --cursor or --all)")
            return 0


def cmd_status(args) -> int:
    if args.watch:
        from repro_torch.api.client import ApiClient
        client = ApiClient(_transport(args), _key(args),
                           prefer_sse=not args.long_poll)
        for v in client.watch_status(args.job_id, wait_ms=args.wait_ms):
            print(f"{v.job_id} {v.status:12s} step={v.progress_step:<6d} "
                  f"{v.message}", flush=True)
        return 0
    v = _transport(args).status(_key(args), args.job_id)
    _print_json({"job_id": v.job_id, "name": v.name, "tenant": v.tenant,
                 "status": v.status, "progress_step": v.progress_step,
                 "submitted_at": v.submitted_at,
                 "finished_at": v.finished_at, "message": v.message})
    return 0


def cmd_history(args) -> int:
    for ts, status, msg in _transport(args).status_history(_key(args),
                                                           args.job_id):
        print(f"{ts:10.1f}  {status:12s} {msg}")
    return 0


def cmd_logs(args) -> int:
    if args.follow:
        from repro_torch.api.client import ApiClient
        client = ApiClient(_transport(args), _key(args),
                           prefer_sse=not args.long_poll)
        for line in client.follow_logs(args.job_id, cursor=args.cursor,
                                       wait_ms=args.wait_ms):
            print(line, flush=True)
        return 0
    t = _transport(args)
    cursor = args.cursor
    while True:
        page = t.logs(_key(args), args.job_id, cursor=cursor,
                      limit=args.limit)
        for line in page.items:
            print(line)
        cursor = page.next_cursor
        if cursor is None:
            return 0
        if args.limit is not None:  # --limit means exactly one page
            print(f"# next cursor: {cursor}  (pass --cursor to continue)")
            return 0


def cmd_search(args) -> int:
    page = _transport(args).search_logs(_key(args), args.query,
                                        job_id=args.job, cursor=args.cursor,
                                        limit=args.limit)
    for rec in page.items:
        print(f"{rec.job_id} learner={rec.learner} {rec.line}")
    if page.next_cursor is not None:
        print(f"# next cursor: {page.next_cursor}  (pass --cursor)")
    return 0


def cmd_events(args) -> int:
    from repro_torch.api.client import ApiClient
    client = ApiClient(_transport(args), _key(args),
                       prefer_sse=not args.long_poll)
    if args.follow:
        try:
            for e in client.follow_events(cursor=args.cursor,
                                          kind=args.kind,
                                          wait_ms=args.wait_ms):
                print(json.dumps(e), flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    out = client.events(cursor=args.cursor, limit=args.limit,
                        kind=args.kind)
    for e in out["items"]:
        print(json.dumps(e))
    if out["missed"]:
        print(f"# {out['missed']} events aged out of retention before "
              f"this cursor", file=sys.stderr)
    print(f"# next cursor: {out['next_cursor']}", file=sys.stderr)
    return 0


def cmd_usage(args) -> int:
    from repro_torch.api.client import ApiClient
    rows = ApiClient(_transport(args), _key(args)).usage(tenant=args.tenant)
    for u in rows:
        print(f"{u['tenant']:16s} chip_s={u['chip_seconds']:<10g} "
              f"jobs={u['jobs_submitted']}/{u['jobs_completed']}"
              f"/{u['jobs_failed']} (sub/done/fail) "
              f"log_bytes={u['log_bytes']} 429s={u['throttled_429s']}")
    return 0


def cmd_halt(args) -> int:
    _transport(args).halt(_key(args), args.job_id, requeue=args.requeue)
    print(f"{args.job_id} halted")
    return 0


def cmd_resume(args) -> int:
    _transport(args).resume(_key(args), args.job_id)
    print(f"{args.job_id} resumed")
    return 0


def cmd_cancel(args) -> int:
    _transport(args).cancel(_key(args), args.job_id)
    print(f"{args.job_id} cancelled")
    return 0


# -- v2 admin plane (operator key with the 'admin' scope) ------------------

def _admin(args):
    from repro_torch.api.client import AdminClient
    return AdminClient(_transport(args), _key(args))


def cmd_admin_shards(args) -> int:
    for s in _admin(args).list_shards():
        flags = ("cordoned" if s["cordoned"] else "") or ""
        print(f"{s['shard_id']:10s} {s['status']:5s} "
              f"chips={s['chips_used']}/{s['chips_total']} "
              f"jobs={s['jobs']} active={s['active_jobs']} "
              f"queue={s['queue_depth']} "
              f"tenants={','.join(s['tenants']) or '-'} {flags}")
    return 0


def cmd_admin_tenants(args) -> int:
    for t in _admin(args).list_tenants():
        quota = t["quota_chips"] if t["quota_chips"] is not None else "-"
        rate = f"{t['rate']}/{t['burst']}" if t["rate"] is not None else "-"
        mig = " (migrating)" if t["migrating"] else ""
        print(f"{t['name']:16s} shard={t['shard']:10s} quota={quota} "
              f"tier={t['tier']} rate={rate}{mig}")
    return 0


def _tenant_fields(args) -> dict:
    fields = {}
    if args.quota is not None:
        fields["quota_chips"] = args.quota
    if args.tier is not None:
        fields["tier"] = args.tier
    if args.rate is not None:
        fields["rate"] = args.rate
    if args.burst is not None:
        fields["burst"] = args.burst
    return fields


def cmd_admin_create_tenant(args) -> int:
    fields = _tenant_fields(args)
    if args.shard is not None:
        fields["shard"] = args.shard
    _print_json(_admin(args).create_tenant(args.name, **fields))
    return 0


def cmd_admin_patch_tenant(args) -> int:
    _print_json(_admin(args).patch_tenant(args.name, **_tenant_fields(args)))
    return 0


def cmd_admin_delete_tenant(args) -> int:
    _print_json(_admin(args).delete_tenant(args.name))
    return 0


def cmd_admin_cordon(args) -> int:
    _print_json(_admin(args).cordon(args.shard_id))
    return 0


def cmd_admin_uncordon(args) -> int:
    _print_json(_admin(args).uncordon(args.shard_id))
    return 0


def cmd_admin_drain(args) -> int:
    _print_json(_admin(args).drain(args.shard_id))
    return 0


def _wait_migration(admin, migration_id: str, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        m = admin.migration(migration_id)
        if m["phase"] in ("DONE", "FAILED") or time.monotonic() > deadline:
            return m
        time.sleep(0.2)


def cmd_admin_migrate(args) -> int:
    admin = _admin(args)
    m = admin.migrate(args.tenant, args.to_shard)
    if args.wait:
        m = _wait_migration(admin, m["migration_id"], args.timeout)
        _print_json(m)
        # a timed-out wait leaves the migration in-flight: that is NOT
        # success (scripts chain `--wait && decommission-source`)
        return 0 if m["phase"] == "DONE" else 1
    _print_json(m)
    return 0 if m["phase"] != "FAILED" else 1


def cmd_admin_operator(args) -> int:
    st = _admin(args).operator_status()
    ro = st.get("rollout")
    ro_line = "-"
    if ro is not None:
        ro_line = (f"{ro['version']} [{ro['state']}] wave {ro['wave']}"
                   + (f" on {ro['shard']}" if ro.get("shard") else ""))
    print(f"tick {st['tick']}  occupancy {st['occupancy']:.2f}  "
          f"rollout {ro_line}")
    for d in st["decisions"][-args.last:]:
        extra = {k: v for k, v in d.items()
                 if k not in ("tick", "action", "reason")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        print(f"  t={d['tick']:<6d} {d['action']:<18s} {detail}")
        print(f"           {d['reason']}")
    return 0


def cmd_admin_rollout(args) -> int:
    admin = _admin(args)
    st = admin.rollout(args.version)
    if not args.wait:
        _print_json(st["rollout"])
        return 0
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        ro = admin.operator_status().get("rollout") or {}
        if ro.get("state") in ("done", "halted"):
            _print_json(ro)
            return 0 if ro["state"] == "done" else 1
        time.sleep(0.2)
    print("timed out waiting for rollout", file=sys.stderr)
    return 1


def cmd_admin_migrations(args) -> int:
    for m in _admin(args).list_migrations():
        print(f"{m['migration_id']} {m['tenant']:16s} "
              f"{m['from_shard']} -> {m['to_shard']} {m['phase']:8s} "
              f"{m['error']}")
    return 0


def cmd_admin_migration(args) -> int:
    _print_json(_admin(args).migration(args.migration_id))
    return 0


def _workloads(args):
    from repro_torch.api.client import WorkloadClient
    return WorkloadClient(_transport(args), _key(args))


def cmd_apply(args) -> int:
    text = (sys.stdin.read() if args.file == "-"
            else open(args.file, encoding="utf-8").read())
    view = _workloads(args).apply(text)
    verb = "created" if view.get("created") else "configured"
    print(f"{view['kind'].lower()}/{view['name']} {verb} "
          f"(generation {view['generation']})")
    return 0


def _workload_row(v) -> str:
    st = v["status"]
    detail = ""
    if v["kind"] == "Pipeline":
        done = sum(1 for s in st["stages"].values() if s["state"] == "DONE")
        detail = f"stages={done}/{len(st['stages'])}"
    elif v["kind"] == "RecurringJob":
        detail = f"runs={st['runs']} skipped={st['skipped']}"
    else:
        detail = (f"ready={len(st['ready_slots'])}/"
                  f"{v['spec']['replicas']}")
    return (f"{v['kind']:13s} {v['tenant']:12s} {v['name']:20s} "
            f"{st['phase']:10s} gen={v['generation']:<3d} {detail}")


def cmd_workloads_list(args) -> int:
    for v in _workloads(args).list(tenant=args.tenant):
        print(_workload_row(v))
    return 0


def cmd_workloads_get(args) -> int:
    _print_json(_workloads(args).get(args.name, tenant=args.tenant))
    return 0


def cmd_workloads_delete(args) -> int:
    view = _workloads(args).delete(args.name, tenant=args.tenant)
    print(f"{view['kind'].lower()}/{view['name']} deleted")
    return 0


def cmd_workloads_invoke(args) -> int:
    payload = json.loads(args.payload) if args.payload else None
    _print_json(_workloads(args).invoke(args.name, payload=payload,
                                        tenant=args.tenant))
    return 0


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ffdl",
        description="CLI for the FfDL v1 HTTP API (see docs/api.md)")
    ap.add_argument("--endpoint",
                    default=os.environ.get("FFDL_ENDPOINT", DEFAULT_ENDPOINT),
                    help="API base URL (env FFDL_ENDPOINT)")
    ap.add_argument("--key", default=os.environ.get("FFDL_API_KEY"),
                    help="tenant API key (env FFDL_API_KEY)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run a local platform + HTTP server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8084)
    s.add_argument("--shards", type=int, default=1,
                   help="independent platform shards behind the gateway "
                        "(tenants are hash-routed; job ids stay unique)")
    s.add_argument("--hosts", type=int, default=8)
    s.add_argument("--chips-per-host", type=int, default=4)
    s.add_argument("--tenant", action="append",
                   help="issue a key for this tenant (repeatable)")
    s.add_argument("--rate", type=float, default=200.0,
                   help="per-tenant req/s (0 disables rate limiting)")
    s.add_argument("--burst", type=int, default=100)
    s.add_argument("--max-inflight", type=int, default=64)
    s.add_argument("--tick-period", type=float, default=0.05,
                   help="wall seconds between simulation ticks")
    s.add_argument("--operator", action="store_true",
                   help="install the autonomous operator (autoscaling, "
                        "hot-tenant isolation, rolling upgrades)")
    s.add_argument("--device", default="cuda",
                   help="where jobs with an arch train (default: the card)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("health", help="GET /v1/health")
    s.set_defaults(fn=cmd_health)

    s = sub.add_parser("submit", help="POST /v1/jobs")
    s.add_argument("--name", required=True)
    s.add_argument("--tenant", default="demo")
    s.add_argument("--learners", type=int, default=1)
    s.add_argument("--chips", type=int, default=1,
                   help="chips per learner")
    s.add_argument("--sim-duration", type=float, default=120.0)
    s.add_argument("--idempotency-key",
                   help="sent as the Idempotency-Key header")
    s.add_argument("--extra", help="extra manifest fields as a JSON object")
    s.set_defaults(fn=cmd_submit)

    s = sub.add_parser("list", help="GET /v1/jobs (cursor-paginated)")
    s.add_argument("--tenant")
    s.add_argument("--status")
    s.add_argument("--cursor")
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--all", action="store_true",
                   help="follow next_cursor to exhaustion")
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("status", help="GET /v1/jobs/{id}")
    s.add_argument("job_id")
    s.add_argument("--watch", "-w", action="store_true",
                   help="long-poll and print every status change until "
                        "the job reaches a terminal state")
    s.add_argument("--wait-ms", type=int, default=8000,
                   help="server-side park per --watch poll (capped 10s)")
    s.add_argument("--long-poll", action="store_true",
                   help="force long-poll for --watch instead of one SSE "
                        "stream")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("history", help="GET /v1/jobs/{id}/history")
    s.add_argument("job_id")
    s.set_defaults(fn=cmd_history)

    s = sub.add_parser("logs", help="GET /v1/jobs/{id}/logs")
    s.add_argument("job_id")
    s.add_argument("--cursor")
    s.add_argument("--limit", type=int,
                   help="print at most this many lines (one page); "
                        "default: follow cursors to the end")
    s.add_argument("--follow", "-f", action="store_true",
                   help="long-poll for new lines until the job reaches a "
                        "terminal state")
    s.add_argument("--wait-ms", type=int, default=8000,
                   help="server-side park per --follow poll (capped 10s)")
    s.add_argument("--long-poll", action="store_true",
                   help="force long-poll for --follow instead of one SSE "
                        "stream")
    s.set_defaults(fn=cmd_logs)

    s = sub.add_parser("search", help="GET /v1/logs/search")
    s.add_argument("query")
    s.add_argument("--job", help="restrict to one job id")
    s.add_argument("--cursor")
    s.add_argument("--limit", type=int)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("events", help="GET /v2/events (platform event "
                                      "stream; one JSON object per line)")
    s.add_argument("--cursor", help="resume from this event cursor")
    s.add_argument("--kind", help="only events of this kind")
    s.add_argument("--limit", type=int, help="page size (no --follow)")
    s.add_argument("--follow", "-f", action="store_true",
                   help="stream new events until interrupted")
    s.add_argument("--wait-ms", type=int, default=8000,
                   help="server-side park per --follow poll (capped 10s)")
    s.add_argument("--long-poll", action="store_true",
                   help="force long-poll instead of one SSE stream")
    s.set_defaults(fn=cmd_events)

    s = sub.add_parser("usage", help="GET /v1/usage (per-tenant metering)")
    s.add_argument("--tenant", help="one tenant's row (admin keys)")
    s.set_defaults(fn=cmd_usage)

    s = sub.add_parser("halt", help="POST /v1/jobs/{id}/halt")
    s.add_argument("job_id")
    s.add_argument("--requeue", action="store_true")
    s.set_defaults(fn=cmd_halt)

    s = sub.add_parser("resume", help="POST /v1/jobs/{id}/resume")
    s.add_argument("job_id")
    s.set_defaults(fn=cmd_resume)

    s = sub.add_parser("cancel", help="DELETE /v1/jobs/{id}")
    s.add_argument("job_id")
    s.set_defaults(fn=cmd_cancel)

    # -- v2 admin plane ----------------------------------------------------
    adm = sub.add_parser(
        "admin", help="v2 admin control plane (operator key with the "
                      "'admin' scope; see docs/api.md)")
    asub = adm.add_subparsers(dest="admin_cmd", required=True)

    s = asub.add_parser("shards", help="GET /v2/admin/shards")
    s.set_defaults(fn=cmd_admin_shards)
    for name, fn in (("cordon", cmd_admin_cordon),
                     ("uncordon", cmd_admin_uncordon),
                     ("drain", cmd_admin_drain)):
        s = asub.add_parser(name,
                            help=f"POST /v2/admin/shards/{{id}}/{name}")
        s.add_argument("shard_id")
        s.set_defaults(fn=fn)

    s = asub.add_parser("tenants", help="GET /v2/admin/tenants")
    s.set_defaults(fn=cmd_admin_tenants)
    for name, fn, with_shard in (
            ("create-tenant", cmd_admin_create_tenant, True),
            ("patch-tenant", cmd_admin_patch_tenant, False)):
        s = asub.add_parser(name)
        s.add_argument("name")
        s.add_argument("--quota", type=int, help="chip quota")
        s.add_argument("--tier", choices=("paid", "free"))
        s.add_argument("--rate", type=float, help="req/s rate limit")
        s.add_argument("--burst", type=int)
        if with_shard:
            s.add_argument("--shard", help="pin to a named shard")
        s.set_defaults(fn=fn)
    s = asub.add_parser("delete-tenant",
                        help="DELETE /v2/admin/tenants/{name}")
    s.add_argument("name")
    s.set_defaults(fn=cmd_admin_delete_tenant)

    s = asub.add_parser("migrate",
                        help="POST /v2/admin/migrations (tenant -> shard)")
    s.add_argument("tenant")
    s.add_argument("to_shard")
    s.add_argument("--wait", action="store_true",
                   help="poll until DONE/FAILED")
    s.add_argument("--timeout", type=float, default=60.0)
    s.set_defaults(fn=cmd_admin_migrate)
    s = asub.add_parser("migrations", help="GET /v2/admin/migrations")
    s.set_defaults(fn=cmd_admin_migrations)
    s = asub.add_parser("migration",
                        help="GET /v2/admin/migrations/{id}")
    s.add_argument("migration_id")
    s.set_defaults(fn=cmd_admin_migration)

    s = asub.add_parser("operator",
                        help="GET /v2/admin/operator (status + decisions)")
    s.add_argument("--last", type=int, default=20,
                   help="show only the last N decisions")
    s.set_defaults(fn=cmd_admin_operator)
    s = asub.add_parser("rollout",
                        help="POST /v2/admin/operator/rollout "
                             "(rolling shard upgrade)")
    s.add_argument("version")
    s.add_argument("--wait", action="store_true",
                   help="poll until done/halted")
    s.add_argument("--timeout", type=float, default=120.0)
    s.set_defaults(fn=cmd_admin_rollout)

    # v2 workloads plane (tenant- or admin-keyed)
    s = sub.add_parser("apply",
                       help="POST /v2/workloads (apply a Pipeline / "
                            "RecurringJob / Service manifest)")
    s.add_argument("-f", "--file", required=True,
                   help="manifest file (JSON or YAML subset); '-' = stdin")
    s.set_defaults(fn=cmd_apply)

    wl = sub.add_parser("workloads", help="v2 workloads plane resources")
    wsub = wl.add_subparsers(dest="workloads_cmd", required=True)
    s = wsub.add_parser("list", help="GET /v2/workloads")
    s.add_argument("--tenant", help="admin keys: which tenant "
                                    "(omit for all)")
    s.set_defaults(fn=cmd_workloads_list)
    s = wsub.add_parser("get", help="GET /v2/workloads/{name}")
    s.add_argument("name")
    s.add_argument("--tenant", help="admin keys must pass this")
    s.set_defaults(fn=cmd_workloads_get)
    s = wsub.add_parser("delete", help="DELETE /v2/workloads/{name} "
                                       "(cascades + cancels)")
    s.add_argument("name")
    s.add_argument("--tenant", help="admin keys must pass this")
    s.set_defaults(fn=cmd_workloads_delete)
    s = wsub.add_parser("invoke",
                        help="POST /v2/workloads/{name}/invoke (one "
                             "inference request against a Service)")
    s.add_argument("name")
    s.add_argument("--payload", help="JSON request payload")
    s.add_argument("--tenant", help="admin keys must pass this")
    s.set_defaults(fn=cmd_workloads_invoke)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ApiError as e:
        msg = f"error [{e.code.value}]: {e.message}"
        if e.retry_after is not None:
            msg += f" (retry after {e.retry_after}s)"
        print(msg, file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
