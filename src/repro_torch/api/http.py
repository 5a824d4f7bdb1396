"""JSON-over-HTTP transport for the v1 API tier (FfDL §3.2).

The port's copy of the reference's ``repro/api/http.py``, its code
unchanged: every route, status code, header, body and error envelope is
the reference's for the same calls.

FfDL's user-facing surface is a replicated REST tier behind a load
balancer; this module serves our v1 envelope contract over a real wire
using only the stdlib (``http.server``, threaded — no new dependencies).
The full contract is written down in ``docs/api.md`` and pinned by
``tests/test_docs_api.py``, on the port by ``tests/test_torch_http.py``.

Server side
    :class:`ApiHttpServer` mounts the routes below over a platform's (or
    :class:`~repro_torch.api.federation.Federation`'s) ``LoadBalancer`` — so
    HTTP composes with replica crash-masking — with an optional
    :class:`~repro_torch.api.ratelimit.RateLimitedApi` front (per-tenant token
    buckets + bounded in-flight gate → 429 with ``Retry-After``).
    Locking is per-shard inside the gateway (reads share a shard's RW
    lock, writes take it exclusively; see ``repro_torch.api.backend``), so a
    read on one shard never queues behind a submit — or a simulation
    tick — on another. ``server.lock`` remains for code that ticks the
    sim from another thread (``with server.lock: platform.tick()``): it
    takes every shard's write lock in shard order. Throttled calls are
    rejected *before* any lock, which is what keeps a flooding tenant
    cheap.

Client side
    :class:`HttpTransport` speaks the wire protocol and re-raises wire
    errors as ``ApiError`` with the original stable code — the same
    contract as the in-process transports, so
    ``ApiClient(HttpTransport(url), key)`` behaves like
    ``ApiClient(platform.api, key)``.

Routes (``{job_id}`` is a path segment)::

    GET    /v1/health                   liveness + replica counts (no auth)
    POST   /v1/jobs                     submit        (201; 200 when deduped)
    GET    /v1/jobs                     list_jobs     (tenant,status,cursor,limit)
    GET    /v1/jobs/{job_id}            status → JobView (wait_ms,last_status
                                        = watch long-poll)
    GET    /v1/jobs/{job_id}/history    status_history
    GET    /v1/jobs/{job_id}/logs       logs          (cursor,limit)
    GET    /v1/logs/search              search_logs   (q,job_id,cursor,limit)
    POST   /v1/jobs/{job_id}/halt       halt          (body: {"requeue": bool})
    POST   /v1/jobs/{job_id}/resume     resume
    DELETE /v1/jobs/{job_id}            cancel

The **v2 admin control plane** (``repro_torch.api.admin``; requires an operator
key carrying the ``admin`` scope, envelopes stamped ``"v2"``)::

    POST   /v2/admin/tenants                        create tenant
    GET    /v2/admin/tenants                        list tenants
    GET    /v2/admin/tenants/{tenant}               get tenant
    PATCH  /v2/admin/tenants/{tenant}               patch quota/tier/rate
    DELETE /v2/admin/tenants/{tenant}               delete tenant
    GET    /v2/admin/shards                         list shards + occupancy
    GET    /v2/admin/shards/{shard_id}              get shard
    POST   /v2/admin/shards/{shard_id}/cordon       cordon
    POST   /v2/admin/shards/{shard_id}/uncordon     uncordon
    POST   /v2/admin/shards/{shard_id}/drain        migrate all off + cordon
    POST   /v2/admin/migrations                     start tenant→shard move
    GET    /v2/admin/migrations                     list migrations
    GET    /v2/admin/migrations/{migration_id}      get migration phase

Operator-keyed admin calls bypass the per-tenant rate limiter (they are
the operator's backpressure controls, not tenant traffic); unknown or
tenant keys probing /v2 still spend tokens from their usual bucket. The
error envelope and ``STATUS_OF`` mapping are shared with v1.

The **observability plane** (``repro_torch.obs``)::

    GET    /metrics       Prometheus text exposition (no auth, no envelope)
    GET    /v1/usage      per-tenant usage meter (tenant: own row; admin: all)
    GET    /v2/events     platform event stream, cursor replay (+ SSE)

``/v1/jobs/{id}/logs``, ``/v1/jobs/{id}`` (status) and ``/v2/events``
additionally speak **Server-Sent Events**: a request carrying
``Accept: text/event-stream`` (or ``?stream=sse``) gets one chunked
response that stays open — data frames with resume ids, ``: hb``
heartbeat comments while idle, an ``event: end`` frame when a followed
job goes terminal. A reconnecting client sends ``Last-Event-ID`` and the
stream resumes exactly after it. Long-poll (``wait_ms``) remains the
fallback contract on the same routes.

Headers: ``Authorization: Bearer <key>`` on every authenticated route;
``Idempotency-Key`` on submit; ``Retry-After`` on 429/503 responses;
``Accept: text/event-stream`` + ``Last-Event-ID`` for SSE.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import socket
import sys
import threading
import time
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import parse as urlparse

from repro_torch.api.backend import AllShardsLock
from repro_torch.api.ratelimit import RateLimitConfig, RateLimitedApi
from repro_torch.api.router import (
    OFFSET_CURSOR_RE,
    encode_composite_cursor,
    parse_composite_cursor,
)
from repro_torch.api.types import (
    ADMIN_API_VERSION,
    API_VERSION,
    ApiError,
    ErrorCode,
    JobView,
    Page,
    SubmitRequest,
    SubmitResponse,
)
from repro_torch.core.faults import BREAKER_STATE_VALUE
from repro_torch.core.helpers import LogRecord
from repro_torch.core.types import JobManifest, JobStatus, TERMINAL
from repro_torch.obs import (
    Histogram,
    SSE_CONTENT_TYPE,
    UsageMeter,
    format_comment,
    format_event,
    iter_sse,
    render_metrics,
)

# job statuses as they appear on the wire
_TERMINAL_WIRE = {s.value for s in TERMINAL}

# Stable ErrorCode → HTTP status mapping. docs/api.md documents exactly
# this table and tests/test_docs_api.py fails if they ever diverge (or if
# a new code is added without a mapping).
STATUS_OF = {
    ErrorCode.UNAUTHENTICATED: 401,
    ErrorCode.FORBIDDEN: 403,
    ErrorCode.NOT_FOUND: 404,
    ErrorCode.INVALID_ARGUMENT: 400,
    ErrorCode.QUOTA_EXCEEDED: 429,
    ErrorCode.FAILED_PRECONDITION: 409,
    ErrorCode.CONFLICT: 409,
    ErrorCode.UNAVAILABLE: 503,
    ErrorCode.UNSUPPORTED_VERSION: 400,
    ErrorCode.RATE_LIMITED: 429,
    ErrorCode.DEADLINE_EXCEEDED: 504,
}

# Canonical route table (docs/api.md is checked against this).
ROUTES = (
    ("GET", "/v1/health"),
    ("POST", "/v1/jobs"),
    ("GET", "/v1/jobs"),
    ("GET", "/v1/jobs/{job_id}"),
    ("GET", "/v1/jobs/{job_id}/history"),
    ("GET", "/v1/jobs/{job_id}/logs"),
    ("GET", "/v1/logs/search"),
    ("POST", "/v1/jobs/{job_id}/halt"),
    ("POST", "/v1/jobs/{job_id}/resume"),
    ("DELETE", "/v1/jobs/{job_id}"),
)

# The v2 admin control plane (docs/api.md is checked against this too).
ADMIN_ROUTES = (
    ("POST", "/v2/admin/tenants"),
    ("GET", "/v2/admin/tenants"),
    ("GET", "/v2/admin/tenants/{tenant}"),
    ("PATCH", "/v2/admin/tenants/{tenant}"),
    ("DELETE", "/v2/admin/tenants/{tenant}"),
    ("GET", "/v2/admin/shards"),
    ("GET", "/v2/admin/shards/{shard_id}"),
    ("POST", "/v2/admin/shards/{shard_id}/cordon"),
    ("POST", "/v2/admin/shards/{shard_id}/uncordon"),
    ("POST", "/v2/admin/shards/{shard_id}/drain"),
    ("POST", "/v2/admin/migrations"),
    ("GET", "/v2/admin/migrations"),
    ("GET", "/v2/admin/migrations/{migration_id}"),
    ("GET", "/v2/admin/operator"),
    ("POST", "/v2/admin/operator/rollout"),
    ("POST", "/v2/admin/faults"),
    ("GET", "/v2/admin/faults"),
    ("DELETE", "/v2/admin/faults"),
    ("DELETE", "/v2/admin/faults/{fault_id}"),
)

# The v2 workloads plane (docs/api.md is checked against this too).
# Tenant-scoped, unlike /v2/admin: a tenant key addresses its own
# workloads, an admin key anyone's (with ?tenant=).
WORKLOAD_ROUTES = (
    ("POST", "/v2/workloads"),
    ("GET", "/v2/workloads"),
    ("GET", "/v2/workloads/{name}"),
    ("DELETE", "/v2/workloads/{name}"),
    ("POST", "/v2/workloads/{name}/invoke"),
)

# The observability plane (docs/api.md is checked against this as well).
OBS_ROUTES = (
    ("GET", "/metrics"),
    ("GET", "/v1/usage"),
    ("GET", "/v2/events"),
)

# Declarative dispatch: every pinned route resolves to exactly one
# ``_h_*`` handler method, and every handler is routed: the reference's
# REG-ROUTE analyzer enforces both directions against its copy of the
# tables above, so a route can no longer exist only in an if-chain (or a
# handler only in dead code). Handlers share one signature:
# ``handler(key, qs, params)`` with ``params`` the template's ``{...}``
# segments already extracted.
ROUTE_HANDLERS = {
    "GET /v1/health": "_h_health",
    "GET /metrics": "_h_metrics",
    "POST /v1/jobs": "_h_submit",
    "GET /v1/jobs": "_h_list_jobs",
    "GET /v1/jobs/{job_id}": "_h_job_status",
    "GET /v1/jobs/{job_id}/history": "_h_job_history",
    "GET /v1/jobs/{job_id}/logs": "_h_job_logs",
    "GET /v1/logs/search": "_h_search_logs",
    "POST /v1/jobs/{job_id}/halt": "_h_job_halt",
    "POST /v1/jobs/{job_id}/resume": "_h_job_resume",
    "DELETE /v1/jobs/{job_id}": "_h_job_cancel",
    "GET /v1/usage": "_h_usage",
    "GET /v2/events": "_h_events",
    "POST /v2/admin/tenants": "_h_admin_create_tenant",
    "GET /v2/admin/tenants": "_h_admin_list_tenants",
    "GET /v2/admin/tenants/{tenant}": "_h_admin_get_tenant",
    "PATCH /v2/admin/tenants/{tenant}": "_h_admin_patch_tenant",
    "DELETE /v2/admin/tenants/{tenant}": "_h_admin_delete_tenant",
    "GET /v2/admin/shards": "_h_admin_list_shards",
    "GET /v2/admin/shards/{shard_id}": "_h_admin_get_shard",
    "POST /v2/admin/shards/{shard_id}/cordon": "_h_admin_cordon",
    "POST /v2/admin/shards/{shard_id}/uncordon": "_h_admin_uncordon",
    "POST /v2/admin/shards/{shard_id}/drain": "_h_admin_drain",
    "POST /v2/admin/migrations": "_h_admin_start_migration",
    "GET /v2/admin/migrations": "_h_admin_list_migrations",
    "GET /v2/admin/migrations/{migration_id}": "_h_admin_get_migration",
    "GET /v2/admin/operator": "_h_admin_operator_status",
    "POST /v2/admin/operator/rollout": "_h_admin_start_rollout",
    "POST /v2/admin/faults": "_h_admin_install_fault",
    "GET /v2/admin/faults": "_h_admin_list_faults",
    "DELETE /v2/admin/faults": "_h_admin_clear_faults",
    "DELETE /v2/admin/faults/{fault_id}": "_h_admin_clear_fault",
    "POST /v2/workloads": "_h_workload_apply",
    "GET /v2/workloads": "_h_workload_list",
    "GET /v2/workloads/{name}": "_h_workload_get",
    "DELETE /v2/workloads/{name}": "_h_workload_delete",
    "POST /v2/workloads/{name}/invoke": "_h_workload_invoke",
}

# Probe-able endpoints: served before (and without) credentials, like
# every liveness/scrape surface should be.
UNAUTHENTICATED_ROUTES = frozenset({"GET /v1/health", "GET /metrics"})

MAX_BODY_BYTES = 1 << 20  # a manifest is small; reject anything bigger
# An oversized-but-bounded body is still drained (so the 400 envelope is
# delivered cleanly and the keep-alive connection survives); beyond this
# cap we stop reading and close the connection instead.
MAX_DRAIN_BYTES = 4 * MAX_BODY_BYTES

_MANIFEST_FIELDS = {f.name for f in dataclasses.fields(JobManifest)}


# --------------------------------------------------------------------------
# Wire codecs
# --------------------------------------------------------------------------

def manifest_from_wire(d) -> JobManifest:
    if not isinstance(d, dict):
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       "manifest must be a JSON object")
    unknown = sorted(set(d) - _MANIFEST_FIELDS)
    if unknown:
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"unknown manifest fields: {unknown}")
    if "name" not in d:
        raise ApiError(ErrorCode.INVALID_ARGUMENT, "manifest.name is required")
    try:
        return JobManifest(**d)
    except TypeError as e:
        raise ApiError(ErrorCode.INVALID_ARGUMENT, f"bad manifest: {e}")


def error_to_wire(err: ApiError, version: str = API_VERSION) -> dict:
    return {"api_version": version,
            "error": {"code": err.code.value, "message": err.message,
                      "details": err.details}}


def _page_to_wire(page: Page, items) -> dict:
    return {"api_version": API_VERSION, "items": items,
            "next_cursor": page.next_cursor}


def _search_rec_to_wire(rec) -> dict:
    if isinstance(rec, LogRecord):
        return dataclasses.asdict(rec)
    return dict(rec)


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # One buffered write per response + no Nagle: without these, the
    # status line / headers / body go out as separate small segments and
    # loopback latency jumps to the delayed-ACK timer (~40ms tails).
    wbufsize = -1
    disable_nagle_algorithm = True
    timeout = 30  # bound stuck reads; a stalled client can't pin a thread
    ctx: "ApiHttpServer"  # bound per-server via a dynamic subclass

    # -- plumbing ---------------------------------------------------------
    def log_message(self, *_args):  # no stderr noise from the test suite
        pass

    def _send_json(self, status: int, payload: dict,
                   extra_headers: Optional[dict] = None):
        self._drain_unread_body()  # keep-alive: never leave request bytes
        self._status_sent = status
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        if self.close_connection:  # e.g. an undrainable oversized body
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_error_envelope(self, err: ApiError):
        headers = {}
        if err.code == ErrorCode.RATE_LIMITED:
            headers["Retry-After"] = max(1, math.ceil(err.retry_after or 0))
        elif err.code == ErrorCode.UNAVAILABLE:
            headers["Retry-After"] = 1
        version = getattr(self, "_envelope_version", API_VERSION)
        self._send_json(STATUS_OF[err.code],
                        error_to_wire(err, version), headers)

    def _api_key(self) -> str:
        auth = self.headers.get("Authorization")
        if auth is None:
            raise ApiError(ErrorCode.UNAUTHENTICATED,
                           "missing Authorization header")
        scheme, _, key = auth.partition(" ")
        if scheme.lower() != "bearer" or not key.strip():
            raise ApiError(ErrorCode.UNAUTHENTICATED,
                           "Authorization must be 'Bearer <api-key>'")
        return key.strip()

    def _content_length(self) -> int:
        """Never trust the header: a negative value would turn
        ``rfile.read`` into read-until-EOF (thread pinned until the client
        hangs up), a non-numeric one would escape as ValueError."""
        raw = self.headers.get("Content-Length") or "0"
        try:
            n = int(raw)
        except ValueError:
            n = -1
        if n < 0:
            self.close_connection = True  # can't know where the body ends
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"invalid Content-Length: {raw!r}")
        return n

    def _json_body(self) -> dict:
        length = self._content_length()
        if length > MAX_BODY_BYTES:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"request body exceeds {MAX_BODY_BYTES} bytes")
        raw = self.rfile.read(length) if length else b""
        self._body_read = True
        if not raw:
            return {}
        try:
            body = json.loads(raw)
        except ValueError:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "request body is not valid JSON")
        if not isinstance(body, dict):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "request body must be a JSON object")
        return body

    @staticmethod
    def _int_param(qs: dict, name: str) -> Optional[int]:
        raw = qs.get(name, [None])[0]
        if raw is None:
            return None
        try:
            return int(raw)
        except ValueError:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"{name} must be an integer, got {raw!r}")

    # -- routing ----------------------------------------------------------
    @staticmethod
    def _match_route(method: str, parts: list):
        """ROUTES/ADMIN_ROUTES/WORKLOAD_ROUTES/OBS_ROUTES are the
        authoritative tables: anything they don't name is a 404 *before*
        auth, so probing the route space needs no credential and a typo'd
        URL isn't misreported as an auth failure. Returns the matched
        ``("METHOD /template", params)`` — the label request metrics
        aggregate under, plus the extracted ``{...}`` path params — or
        None."""
        for m, template in ROUTES + ADMIN_ROUTES + WORKLOAD_ROUTES \
                + OBS_ROUTES:
            t_parts = [p for p in template.split("/") if p]
            if m == method and len(t_parts) == len(parts) and all(
                    tp.startswith("{") or tp == pp
                    for tp, pp in zip(t_parts, parts)):
                params = {tp[1:-1]: pp for tp, pp in zip(t_parts, parts)
                          if tp.startswith("{")}
                return f"{m} {template}", params
        return None

    def _route(self, method: str):
        """Declarative dispatch: match against the pinned tables, look
        the template up in ``ROUTE_HANDLERS``, authenticate (except the
        probe-able ``UNAUTHENTICATED_ROUTES``), throttle v2 planes, and
        hand off. Operator-keyed v2 traffic bypasses the per-tenant
        rate limiter — those are the operator's backpressure controls,
        not tenant traffic — but unknown/tenant keys still spend a
        token, so credential-guessing floods against /v2 are
        429-throttled before auth exactly like against v1. Workload
        routes ARE tenant traffic (including the serving data path,
        ``…/invoke``) and ride the same buckets as v1: that is the
        serving tier's per-tenant QoS."""
        split = urlparse.urlsplit(self.path)
        qs = urlparse.parse_qs(split.query)
        parts = [p for p in split.path.split("/") if p]

        if parts[:1] == ["v2"]:
            self._envelope_version = ADMIN_API_VERSION
        matched = self._match_route(method, parts)
        if matched is None:
            self._route_template = None
            raise ApiError(ErrorCode.NOT_FOUND,
                           f"no route for {method} {split.path}")
        self._route_template, params = matched
        handler = getattr(self, ROUTE_HANDLERS[self._route_template])
        if self._route_template in UNAUTHENTICATED_ROUTES:
            return handler(None, qs, params)
        key = self._api_key()
        if parts[:2] in (["v2", "admin"], ["v2", "workloads"]) \
                and self.ctx.ratelimiter is not None:
            self.ctx.ratelimiter.throttle_non_admin(key)
        return handler(key, qs, params)

    # -- v1 data plane + observability handlers ---------------------------
    def _h_health(self, key, qs, params):
        return self._health()

    def _h_metrics(self, key, qs, params):
        return self._metrics()  # scrape endpoint: no auth, like health

    def _h_submit(self, key, qs, params):
        return self._submit(self.ctx.api, key)

    def _h_list_jobs(self, key, qs, params):
        return self._list(self.ctx.api, key, qs)

    def _h_job_status(self, key, qs, params):
        api, job_id = self.ctx.api, params["job_id"]
        if self._wants_sse(qs):
            return self._stream_status(api, key, job_id, qs)
        view = api.status(key, job_id,
                          wait_ms=self._int_param(qs, "wait_ms"),
                          last_status=qs.get("last_status", [None])[0])
        return self._send_json(200, dataclasses.asdict(view))

    def _h_job_history(self, key, qs, params):
        hist = self.ctx.api.status_history(key, params["job_id"])
        return self._send_json(200, {"api_version": API_VERSION,
                                     "items": [list(h) for h in hist]})

    def _h_job_logs(self, key, qs, params):
        api, job_id = self.ctx.api, params["job_id"]
        if self._wants_sse(qs):
            return self._stream_logs(api, key, job_id, qs)
        page = api.logs(key, job_id,
                        cursor=qs.get("cursor", [None])[0],
                        limit=self._int_param(qs, "limit"),
                        wait_ms=self._int_param(qs, "wait_ms"))
        return self._send_json(200, _page_to_wire(page, page.items))

    def _h_search_logs(self, key, qs, params):
        query = qs.get("q", [None])[0]
        if query is None:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "missing query parameter 'q'")
        page = self.ctx.api.search_logs(
            key, query,
            job_id=qs.get("job_id", [None])[0],
            cursor=qs.get("cursor", [None])[0],
            limit=self._int_param(qs, "limit"))
        return self._send_json(200, _page_to_wire(
            page, [_search_rec_to_wire(r) for r in page.items]))

    def _h_job_halt(self, key, qs, params):
        body = self._json_body()
        self.ctx.api.halt(key, params["job_id"],
                          requeue=bool(body.get("requeue", False)))
        return self._send_json(200, {"api_version": API_VERSION, "ok": True})

    def _h_job_resume(self, key, qs, params):
        self.ctx.api.resume(key, params["job_id"])
        return self._send_json(200, {"api_version": API_VERSION, "ok": True})

    def _h_job_cancel(self, key, qs, params):
        self.ctx.api.cancel(key, params["job_id"])
        return self._send_json(200, {"api_version": API_VERSION, "ok": True})

    def _h_usage(self, key, qs, params):
        out = self.ctx.api.usage(key, tenant=qs.get("tenant", [None])[0])
        return self._send_json(200, {"api_version": API_VERSION, **out})

    def _h_events(self, key, qs, params):
        api = self.ctx.api
        if self._wants_sse(qs):
            return self._stream_events(api, key, qs)
        out = api.events(key, cursor=qs.get("cursor", [None])[0],
                         limit=self._int_param(qs, "limit"),
                         kind=qs.get("kind", [None])[0],
                         wait_ms=self._int_param(qs, "wait_ms"))
        return self._send_json(200, {"api_version": ADMIN_API_VERSION, **out})

    # -- v2 admin control plane handlers ----------------------------------
    # Resource routes over the shared AdminGateway (platform.admin_api).
    def _h_admin_create_tenant(self, key, qs, params):
        admin = self.ctx.platform.admin_api
        return self._send_json(201, admin.create_tenant(key,
                                                        self._json_body()))

    def _h_admin_list_tenants(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.list_tenants(key))

    def _h_admin_get_tenant(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.get_tenant(key,
                                                        params["tenant"]))

    def _h_admin_patch_tenant(self, key, qs, params):
        admin = self.ctx.platform.admin_api
        return self._send_json(
            200, admin.patch_tenant(key, params["tenant"],
                                    self._json_body()))

    def _h_admin_delete_tenant(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.delete_tenant(
                key, params["tenant"]))

    def _h_admin_list_shards(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.list_shards(key))

    def _h_admin_get_shard(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.get_shard(key,
                                                       params["shard_id"]))

    def _h_admin_cordon(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.cordon_shard(
                key, params["shard_id"]))

    def _h_admin_uncordon(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.uncordon_shard(
                key, params["shard_id"]))

    def _h_admin_drain(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.drain_shard(
                key, params["shard_id"]))

    def _h_admin_start_migration(self, key, qs, params):
        admin = self.ctx.platform.admin_api
        return self._send_json(
            202, admin.start_migration(key, self._json_body()))

    def _h_admin_list_migrations(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.list_migrations(key))

    def _h_admin_get_migration(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.get_migration(
                key, params["migration_id"]))

    def _h_admin_operator_status(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.operator_status(key))

    def _h_admin_start_rollout(self, key, qs, params):
        admin = self.ctx.platform.admin_api
        # 202: waves start on the next federation tick
        return self._send_json(
            202, admin.start_rollout(key, self._json_body()))

    def _h_admin_install_fault(self, key, qs, params):
        admin = self.ctx.platform.admin_api
        return self._send_json(
            201, admin.install_fault(key, self._json_body()))

    def _h_admin_list_faults(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.list_faults(key))

    def _h_admin_clear_faults(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.clear_faults(key))

    def _h_admin_clear_fault(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.admin_api.clear_faults(
                key, params["fault_id"]))

    # -- v2 workloads plane handlers --------------------------------------
    # Declarative manifests as resources over the shared WorkloadGateway
    # (platform.workloads_api).
    def _h_workload_apply(self, key, qs, params):
        body = self._json_body()
        manifest = body.get("manifest_text", body.get("manifest"))
        if manifest is None:
            raise ApiError(
                ErrorCode.INVALID_ARGUMENT,
                "body must carry 'manifest' (object) or "
                "'manifest_text' (JSON/YAML-subset string)")
        view = self.ctx.platform.workloads_api.apply(key, manifest)
        return self._send_json(201 if view["created"] else 200, view)

    def _h_workload_list(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.workloads_api.list_workloads(
                key, tenant=qs.get("tenant", [None])[0]))

    def _h_workload_get(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.workloads_api.get_workload(
                key, params["name"], tenant=qs.get("tenant", [None])[0]))

    def _h_workload_delete(self, key, qs, params):
        return self._send_json(
            200, self.ctx.platform.workloads_api.delete_workload(
                key, params["name"], tenant=qs.get("tenant", [None])[0]))

    def _h_workload_invoke(self, key, qs, params):
        body = self._json_body()
        return self._send_json(
            200, self.ctx.platform.workloads_api.invoke_workload(
                key, params["name"], payload=body.get("payload"),
                tenant=qs.get("tenant", [None])[0]))

    def _health(self):
        """Liveness, aggregated over replicas AND backend shards: the
        top-level shape (status/replicas_alive/replicas_total) is stable;
        ``shards`` details each backend so operators see a dead shard
        even while every replica is up (the tier then reports
        "degraded" — that shard's tenants are getting UNAVAILABLE)."""
        replicas = self.ctx.platform.api_replicas
        backends = self.ctx.platform.router.backends
        alive = sum(1 for r in replicas if r.alive)
        shards_alive = sum(1 for b in backends if b.alive)
        degraded = alive < len(replicas) or shards_alive < len(backends)
        status = ("down" if not alive
                  else ("degraded" if degraded else "ok"))
        # additive observability fields (the operator loop reads these to
        # spot a stalled shard without scraping /metrics): uptime_ticks =
        # scheduling rounds, events_seq = the shard's event high-water mark
        self._send_json(200 if alive else 503,
                        {"api_version": API_VERSION, "status": status,
                         "replicas_alive": alive,
                         "replicas_total": len(replicas),
                         "shards_alive": shards_alive,
                         "shards_total": len(backends),
                         "uptime_ticks": max(
                             (getattr(b.platform, "ticks", 0)
                              for b in backends), default=0),
                         "shards": [{"shard_id": b.shard_id,
                                     "status": "ok" if b.alive else "down",
                                     "cordoned": b.cordoned,
                                     # circuit-breaker verdict on the
                                     # shard: closed/half_open/open (open
                                     # = quarantined for gray failure
                                     # even though alive)
                                     "breaker": b.breaker.state,
                                     "uptime_ticks": getattr(
                                         b.platform, "ticks", 0),
                                     "events_seq": b.platform.events.seq}
                                    for b in backends]})

    def _metrics(self):
        """Prometheus text exposition — plain text, not the JSON envelope
        (scrapers speak the exposition format, nothing else)."""
        text = render_metrics(self.ctx.collect_metric_families())
        self._drain_unread_body()
        self._status_sent = 200
        body = text.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- SSE streaming (the true-streaming transport) ---------------------
    def _wants_sse(self, qs: dict) -> bool:
        """``Accept: text/event-stream`` (the standard) or ``?stream=sse``
        (curl-friendly) selects the streaming transport."""
        raw = (qs.get("stream", [None])[0] or "").lower()
        return raw in ("1", "true", "sse") \
            or SSE_CONTENT_TYPE in (self.headers.get("Accept") or "")

    def _start_sse(self):
        """Commit to a chunked event stream. Everything that can fail with
        a normal error envelope (auth, 404, rate limit, stream caps) must
        have happened already — after this point errors go out mid-stream
        as ``event: error`` frames."""
        self._drain_unread_body()
        self.send_response(200)
        self.send_header("Content-Type", SSE_CONTENT_TYPE)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        self._status_sent = 200
        self._sse_started = True

    def _sse_write(self, payload: bytes):
        self.wfile.write(b"%X\r\n" % len(payload) + payload + b"\r\n")
        self.wfile.flush()

    def _sse_end(self):
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _sse_fail(self, err: ApiError):
        """A failure after the stream started: deliver the standard error
        envelope as an ``event: error`` frame, then close. The client
        transport re-raises it as the same ApiError."""
        try:
            version = getattr(self, "_envelope_version", API_VERSION)
            self._sse_write(format_event(
                json.dumps(error_to_wire(err, version)), event="error"))
            self._sse_end()
        except OSError:
            pass  # client already gone

    def _stream_admit(self, key: str):
        """Stream admission, BEFORE the SSE response commits (failures
        here are normal envelopes): the server-wide ``max_streams`` cap
        bounds concurrent streams, and one rate-limit token is spent at
        open — a stream then holds no in-flight slot for its lifetime,
        unlike a parked long-poll."""
        self.ctx.stream_begin()
        try:
            if self.ctx.ratelimiter is not None:
                self.ctx.ratelimiter.admit_once(key)
        except BaseException:
            self.ctx.stream_end()
            raise

    def _sse_budget(self):
        now = time.monotonic()
        return now + self.ctx.max_stream_s, now + self.ctx.heartbeat_s

    def _sse_idle(self, deadline: float, next_beat: float) -> tuple:
        """One idle step: heartbeat if due; returns ``(wait_ms, next_beat,
        expired)`` where ``wait_ms`` is the next inner long-poll budget
        (≥1 so the gateway's follow-cursor contract stays engaged)."""
        now = time.monotonic()
        if now >= deadline:
            return 0, next_beat, True
        if now >= next_beat:
            # count before the write: the client may act on the frame the
            # instant it lands, and the counter must already reflect it
            self.ctx.bump_heartbeat()
            self._sse_write(format_comment("hb"))
            next_beat = now + self.ctx.heartbeat_s
        wait_s = min(next_beat - time.monotonic(), deadline - now)
        return max(1, int(wait_s * 1000)), next_beat, False

    def _stream_logs(self, api, key: str, job_id: str, qs: dict):
        raw = qs.get("cursor", [None])[0] \
            or self.headers.get("Last-Event-ID")
        try:
            cur_off = int(raw) if raw is not None else 0
        except ValueError:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"malformed cursor: {raw!r}")
        self._stream_admit(key)
        try:
            # first call BEFORE the stream commits: auth/404/shard-down
            # still answer as ordinary error envelopes
            page = api.logs(key, job_id, cursor=str(cur_off), wait_ms=1)
            self._start_sse()
            deadline, next_beat = self._sse_budget()
            while True:
                for line in page.items:
                    cur_off += 1
                    # id = the resume cursor AFTER this line: exact
                    # pick-up on reconnect via Last-Event-ID
                    self._sse_write(format_event(json.dumps(line),
                                                 id=str(cur_off)))
                if page.items:
                    next_beat = time.monotonic() + self.ctx.heartbeat_s
                if page.next_cursor is None:  # terminal AND fully consumed
                    self._sse_write(format_event(
                        json.dumps({"job_id": job_id, "cursor": cur_off}),
                        event="end"))
                    self._sse_end()
                    return
                wait_ms, next_beat, expired = self._sse_idle(deadline,
                                                             next_beat)
                if expired:  # stream budget spent: clean close, client
                    self._sse_end()    # reconnects from its Last-Event-ID
                    return
                page = api.logs(key, job_id, cursor=str(cur_off),
                                wait_ms=wait_ms)
        except ApiError as e:
            if not self._sse_started:
                raise
            self._sse_fail(e)
        except OSError:
            pass  # client disconnected mid-stream
        finally:
            self.ctx.stream_end()

    def _stream_status(self, api, key: str, job_id: str, qs: dict):
        last = qs.get("last_status", [None])[0] \
            or self.headers.get("Last-Event-ID")
        self._stream_admit(key)
        try:
            view = api.status(key, job_id, wait_ms=1, last_status=last)
            self._start_sse()
            deadline, next_beat = self._sse_budget()
            while True:
                if view.status != last:
                    # id = the status itself: a reconnect resumes with
                    # Last-Event-ID as last_status and only changes stream
                    self._sse_write(format_event(
                        json.dumps(dataclasses.asdict(view)),
                        event="status", id=view.status))
                    last = view.status
                    next_beat = time.monotonic() + self.ctx.heartbeat_s
                if view.status in _TERMINAL_WIRE:
                    self._sse_write(format_event(
                        json.dumps({"job_id": job_id,
                                    "status": view.status}), event="end"))
                    self._sse_end()
                    return
                wait_ms, next_beat, expired = self._sse_idle(deadline,
                                                             next_beat)
                if expired:
                    self._sse_end()
                    return
                view = api.status(key, job_id, wait_ms=wait_ms,
                                  last_status=last)
        except ApiError as e:
            if not self._sse_started:
                raise
            self._sse_fail(e)
        except OSError:
            pass
        finally:
            self.ctx.stream_end()

    def _stream_events(self, api, key: str, qs: dict):
        cursor = qs.get("cursor", [None])[0] \
            or self.headers.get("Last-Event-ID")
        kind = qs.get("kind", [None])[0]
        self._stream_admit(key)
        try:
            out = api.events(key, cursor=cursor, kind=kind, wait_ms=1)
            # Composite (multi-shard admin) streams carry a composite id
            # per item — maintained incrementally so ANY item's id is an
            # exact resume point; single-shard ids are the plain seq.
            composite = "=" in out["next_cursor"]
            shard_curs: dict = {}
            if composite:
                shard_curs, _ = parse_composite_cursor(
                    cursor, self.ctx.platform.router, OFFSET_CURSOR_RE)
            self._start_sse()
            deadline, next_beat = self._sse_budget()
            while True:
                for item in out["items"]:
                    if composite:
                        shard_curs[item["shard"]] = str(item["seq"])
                        eid = encode_composite_cursor(shard_curs, set())
                    else:
                        eid = str(item["seq"])
                    self._sse_write(format_event(json.dumps(item), id=eid))
                if out["items"]:
                    next_beat = time.monotonic() + self.ctx.heartbeat_s
                cursor = out["next_cursor"]
                if composite:
                    shard_curs, _ = parse_composite_cursor(
                        cursor, self.ctx.platform.router, OFFSET_CURSOR_RE)
                wait_ms, next_beat, expired = self._sse_idle(deadline,
                                                             next_beat)
                if expired:  # the event stream itself never ends
                    self._sse_end()
                    return
                out = api.events(key, cursor=cursor, kind=kind,
                                 wait_ms=wait_ms)
        except ApiError as e:
            if not self._sse_started:
                raise
            self._sse_fail(e)
        except OSError:
            pass
        finally:
            self.ctx.stream_end()

    def _submit(self, api, key: str):
        body = self._json_body()
        if "manifest" not in body:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must carry a 'manifest' object")
        # header wins over body: retried requests re-send the same header
        idem = self.headers.get("Idempotency-Key") \
            or body.get("idempotency_key")
        req = SubmitRequest(
            manifest=manifest_from_wire(body["manifest"]),
            idempotency_key=idem,
            api_version=body.get("api_version", API_VERSION))
        resp = api.submit(key, req)
        self._send_json(200 if resp.deduplicated else 201,
                        dataclasses.asdict(resp))

    def _list(self, api, key: str, qs: dict):
        status_raw = qs.get("status", [None])[0]
        status = None
        if status_raw is not None:
            try:
                status = JobStatus(status_raw)
            except ValueError:
                raise ApiError(ErrorCode.INVALID_ARGUMENT,
                               f"unknown status {status_raw!r}")
        kwargs = {"tenant": qs.get("tenant", [None])[0], "status": status,
                  "cursor": qs.get("cursor", [None])[0]}
        limit = self._int_param(qs, "limit")
        if limit is not None:
            kwargs["limit"] = limit
        page = api.list_jobs(key, **kwargs)
        self._send_json(200, _page_to_wire(
            page, [dataclasses.asdict(v) for v in page.items]))

    def _drain_unread_body(self):
        """A route that never called ``_json_body`` (no-body verbs, or a
        failure before the read) leaves the request body on the socket;
        consume it or the next keep-alive request desyncs. A body too big
        to be worth draining forces the connection closed instead — never
        let the leftover bytes be parsed as the next request."""
        if getattr(self, "_body_read", False):
            return
        self._body_read = True
        try:
            length = self._content_length()
        except ApiError:
            return  # connection already flagged for close
        if 0 < length <= MAX_DRAIN_BYTES:
            self.rfile.read(length)
        elif length > MAX_DRAIN_BYTES:
            self.close_connection = True

    def _handle(self, method: str):
        self._body_read = False
        self._envelope_version = API_VERSION
        self._route_template = None
        self._status_sent = None
        self._sse_started = False
        t0 = time.perf_counter()
        try:
            self._route(method)
        except ApiError as e:
            if not self._sse_started:  # mid-stream failures already went
                self._send_error_envelope(e)  # out as `event: error`
        except Exception as e:  # noqa: BLE001 — never leak a traceback page
            if not self._sse_started:
                self._send_error_envelope(
                    ApiError(ErrorCode.UNAVAILABLE, f"internal error: {e}"))
        finally:
            self.ctx.record_request(
                self._route_template or f"{method} <unrouted>",
                self._status_sent or 0, time.perf_counter() - t0)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")

    # Unused verbs still get the v1 404 envelope, not a bare 501 page.
    def do_PUT(self):
        self._handle("PUT")

    def do_PATCH(self):
        self._handle("PATCH")


class _QuietDisconnectServer(ThreadingHTTPServer):
    """An SSE follower hanging up mid-stream surfaces as a broken pipe
    during connection teardown (after the handler already cleaned up) —
    routine for streams, so don't let socketserver splat a traceback."""

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class ApiHttpServer:
    """Threaded stdlib HTTP server over a platform's (or a
    :class:`~repro_torch.api.federation.Federation`'s) API tier.

    ``rate_limit`` installs a :class:`RateLimitedApi` front (per-tenant
    token buckets + bounded in-flight gate). Verb handlers lock per shard
    inside the gateway (reads shared, writes exclusive); ``lock`` is the
    all-shards write lock — hold it when ticking the simulation from
    another thread (``with server.lock: platform.tick()``). A
    ``Federation`` driver can instead call ``federation.tick()``, which
    locks one shard at a time so other shards keep serving reads.
    """

    def __init__(self, platform, host: str = "127.0.0.1", port: int = 0,
                 rate_limit: Optional[RateLimitConfig] = None,
                 per_tenant: Optional[dict] = None,
                 heartbeat_s: float = 10.0, max_stream_s: float = 3600.0,
                 max_streams: int = 256):
        self.platform = platform
        self.lock = AllShardsLock(platform.router)
        self.ratelimiter = None
        if rate_limit is not None:
            self.ratelimiter = RateLimitedApi(platform.api, platform.auth,
                                              rate_limit, per_tenant)
        self.api = self.ratelimiter or platform.api
        # v2 admin plane: wire the rate limiter in so tenant PATCHes with
        # rate/burst apply live to the token buckets
        admin = getattr(platform, "admin", None)
        if admin is not None and self.ratelimiter is not None:
            admin.attach_ratelimiter(self.ratelimiter)
        # observability: throttles become rate_limited platform events
        if self.ratelimiter is not None:
            self.ratelimiter.attach_observability(platform.router)
        # -- SSE stream plane: cadence of `: hb` heartbeats on an idle
        # stream, per-stream wall budget (a spent stream closes cleanly
        # and the client resumes from its Last-Event-ID), and a server-
        # wide concurrency cap (streams hold no rate-limiter in-flight
        # slot, so they need their own bound).
        self.heartbeat_s = heartbeat_s
        self.max_stream_s = max_stream_s
        self.max_streams = max_streams
        self._metrics_lock = threading.Lock()
        self.streams_opened = 0
        self.streams_active = 0
        self.heartbeats_sent = 0
        # per-route request metrics, fed by every handled request
        self.route_requests: dict = {}   # (template, status) -> count
        self.route_latency: dict = {}    # template -> Histogram
        handler = type("BoundHandler", (_Handler,), {"ctx": self})
        self._httpd = _QuietDisconnectServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    # -- observability plumbing (handler callbacks) -----------------------
    def record_request(self, template: str, status: int, seconds: float):
        with self._metrics_lock:
            k = (template, status)
            self.route_requests[k] = self.route_requests.get(k, 0) + 1
            h = self.route_latency.get(template)
            if h is None:
                h = self.route_latency[template] = Histogram()
        h.observe(seconds)

    def stream_begin(self):
        with self._metrics_lock:
            if self.streams_active >= self.max_streams:
                raise ApiError(
                    ErrorCode.RATE_LIMITED,
                    f"server at max concurrent streams ({self.max_streams})",
                    retry_after=1)
            self.streams_active += 1
            self.streams_opened += 1

    def stream_end(self):
        with self._metrics_lock:
            self.streams_active -= 1

    def bump_heartbeat(self):
        with self._metrics_lock:
            self.heartbeats_sent += 1

    def collect_metric_families(self) -> list:
        """Everything /metrics serves, scraped live. Platform values are
        read WITHOUT shard locks: scrapes are monitoring reads and must
        stay cheap under load — a torn gauge is tolerable, a scrape that
        queues behind a migration cutover is not. Family names are pinned
        in ``repro_torch.obs.METRIC_NAMES``."""
        backends = self.platform.router.backends
        shard_up, chips, occ, qdepth = [], [], [], []
        wal, ev_seq, ev_drop, uptime = [], [], [], []
        brk, ddl = [], []
        snaps = []
        for b in backends:
            lbl = {"shard": b.shard_id}
            p = b.platform
            shard_up.append((lbl, 1 if b.alive else 0))
            brk.append((lbl, BREAKER_STATE_VALUE[b.breaker.state]))
            ddl.append((lbl, b.breaker.deadline_exceeded_total))
            chips.append((lbl, p.cluster.total_chips))
            occ.append((lbl, p.cluster.used_chips))
            qdepth.append((lbl, len(getattr(p.scheduler, "queue", ()))))
            wal.append((lbl, getattr(p.meta, "flushes", 0)))
            ev_seq.append((lbl, p.events.seq))
            ev_drop.append((lbl, p.events.dropped_total))
            uptime.append((lbl, getattr(p, "ticks", 0)))
            snaps.append(p.meter.snapshot())
        usage = UsageMeter.merge(snaps)
        migr = Counter()
        admin = getattr(self.platform, "admin", None)
        if admin is not None:
            for m in admin.migrations.values():
                migr[m.phase.value] += 1
        if self.ratelimiter is not None:
            limited = dict(self.ratelimiter.throttled_by_tenant)
        else:
            limited = {t: row["throttled_429s"] for t, row in usage.items()
                       if row["throttled_429s"]}
        with self._metrics_lock:
            reqs = dict(self.route_requests)
            lat = dict(self.route_latency)
            streams = (self.streams_active, self.streams_opened,
                       self.heartbeats_sent)
        return [
            ("ffdl_uptime_ticks", "gauge",
             "Scheduling rounds completed per shard", uptime),
            ("ffdl_shard_up", "gauge",
             "1 if the shard backend is alive", shard_up),
            ("ffdl_shard_chips_total", "gauge",
             "Total accelerator chips per shard", chips),
            ("ffdl_shard_occupancy_chips", "gauge",
             "Chips currently reserved by placed gangs", occ),
            ("ffdl_scheduler_queue_depth", "gauge",
             "Gangs waiting for placement", qdepth),
            ("ffdl_wal_flushes_total", "counter",
             "Metastore WAL flushes (group commit)", wal),
            ("ffdl_breaker_state", "gauge",
             "Per-shard circuit breaker (0=closed 1=half_open 2=open)",
             brk),
            ("ffdl_deadline_exceeded_total", "counter",
             "Verb/tick deadline overruns recorded against the shard",
             ddl),
            ("ffdl_events_seq", "gauge",
             "Event-bus high-water sequence number", ev_seq),
            ("ffdl_events_dropped_total", "counter",
             "Events dropped by retention", ev_drop),
            ("ffdl_migrations", "gauge", "Migrations by phase",
             [({"phase": ph}, n) for ph, n in sorted(migr.items())]),
            ("ffdl_http_requests_total", "counter",
             "HTTP requests by route and status",
             [({"route": t, "status": str(s)}, n)
              for (t, s), n in sorted(reqs.items())]),
            ("ffdl_http_request_latency_seconds", "histogram",
             "HTTP request latency by route",
             [({"route": t}, h) for t, h in sorted(lat.items())]),
            ("ffdl_http_streams_active", "gauge",
             "SSE streams currently open", [(None, streams[0])]),
            ("ffdl_http_streams_opened_total", "counter",
             "SSE streams opened since start", [(None, streams[1])]),
            ("ffdl_http_heartbeats_total", "counter",
             "SSE heartbeat comments sent", [(None, streams[2])]),
            ("ffdl_rate_limited_total", "counter",
             "Requests answered 429 per tenant",
             [({"tenant": t}, n) for t, n in sorted(limited.items())]),
            ("ffdl_tenant_chip_seconds_total", "counter",
             "Accrued chip-seconds per tenant",
             [({"tenant": t}, row["chip_seconds"])
              for t, row in sorted(usage.items())]),
            ("ffdl_tenant_jobs_total", "counter",
             "Jobs by tenant and outcome",
             [({"tenant": t, "outcome": oc}, row[f"jobs_{oc}"])
              for t, row in sorted(usage.items())
              for oc in ("submitted", "completed", "failed")]),
            ("ffdl_tenant_log_bytes_total", "counter",
             "Log bytes indexed per tenant",
             [({"tenant": t}, row["log_bytes"])
              for t, row in sorted(usage.items())]),
            ("ffdl_tenant_serving_replica_seconds_total", "counter",
             "Ready inference-replica seconds per tenant (workloads "
             "serving tier)",
             [({"tenant": t}, row["serving_replica_seconds"])
              for t, row in sorted(usage.items())]),
        ]

    @property
    def port(self) -> int:
        return self._httpd.server_port

    @property
    def base_url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "ApiHttpServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ApiHttpServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# --------------------------------------------------------------------------
# Client transport
# --------------------------------------------------------------------------

def _error_from_payload(status: int, payload) -> ApiError:
    """Decode a wire error envelope back into an ApiError (shared by the
    request path and the SSE stream path)."""
    try:
        wire = json.loads(payload)["error"]
        if not isinstance(wire, dict) or "code" not in wire:
            wire = None
    except (ValueError, KeyError, TypeError):
        wire = None
    if wire is None:
        err = ApiError(ErrorCode.UNAVAILABLE,
                       f"HTTP {status}: undecodable error body")
    else:
        try:
            code = ErrorCode(wire["code"])
            extra = {}
        except ValueError:
            # a newer server's code this client doesn't know: keep the raw
            # string and fall back to a NON-retryable code (UNAVAILABLE
            # would invite blind re-execution)
            code = ErrorCode.FAILED_PRECONDITION
            extra = {"wire_code": wire["code"]}
        err = ApiError(code, wire.get("message", ""),
                       **{**wire.get("details", {}), **extra})
    err.details.setdefault("http_status", status)
    return err


class HttpTransport:
    """v1 verb surface over the wire — drop-in for the in-process
    ``LoadBalancer`` anywhere a transport is expected (``ApiClient``,
    benchmarks, the ``ffdl`` CLI).

    Connections are persistent (HTTP/1.1 keep-alive) and thread-local, so
    concurrent tenant clients measure the API tier — not per-request TCP
    and thread churn. A connection the server dropped is retried once on a
    fresh socket before surfacing UNAVAILABLE.
    """

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        split = urlparse.urlsplit(self.base_url)
        if split.scheme != "http" or split.hostname is None:
            raise ValueError(f"expected an http:// URL, got {base_url!r}")
        self._host = split.hostname
        self._port = split.port or 80
        self.timeout = timeout
        self._local = threading.local()
        # optional fault-plane attachment: tests/benchmarks point this at
        # a FaultPlane to exercise the wire path's own interposition
        # points (``http.send`` / ``http.recv``) — e.g. a flaky or slow
        # network between client and API tier
        self.faults = None
        self.fault_key: Optional[str] = None
        # transport telemetry (benchmarks/observability.py compares these:
        # one SSE stream replaces a whole long-poll request train)
        self._counters_lock = threading.Lock()
        self.requests_sent = 0
        self.streams_opened = 0

    # -- low-level --------------------------------------------------------
    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
        self._local.conn = None

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self.timeout)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = conn
        return conn

    def _request(self, method: str, path: str, api_key: Optional[str] = None,
                 body: Optional[dict] = None, query: Optional[dict] = None,
                 headers: Optional[dict] = None,
                 allow_error_status: bool = False,
                 timeout_floor: Optional[float] = None) -> tuple[int, dict]:
        with self._counters_lock:
            self.requests_sent += 1
        if query:
            qs = {k: v for k, v in query.items() if v is not None}
            if qs:
                path += "?" + urlparse.urlencode(qs)
        data = json.dumps(body).encode() if body is not None else None
        hdrs = {"Content-Type": "application/json"}
        if api_key is not None:
            hdrs["Authorization"] = f"Bearer {api_key}"
        for k, v in (headers or {}).items():
            if v is not None:
                hdrs[k] = v

        # Retry policy: a reused keep-alive socket may have been closed by
        # the server since the last call; such failures are retried once on
        # a fresh socket — but ONLY when the request cannot have executed
        # (send-phase failure) or the verb is idempotent (GET). A write
        # that succeeded followed by a read failure on a mutating verb is
        # surfaced as UNAVAILABLE instead of silently re-executing it.
        status = payload = None
        for attempt in (0, 1):
            reused = getattr(self._local, "conn", None) is not None
            conn = self._conn()
            # A long-poll (logs wait_ms) may legitimately park server-side
            # longer than the transport's socket timeout: raise this
            # request's read timeout to cover the park, restore after.
            raised_timeout = False
            if timeout_floor is not None and conn.sock is not None \
                    and timeout_floor > self.timeout:
                conn.sock.settimeout(timeout_floor)
                raised_timeout = True
            try:
                if self.faults is not None:
                    self.faults.on("http.send", key=self.fault_key,
                                   exc=lambda m: OSError(m))
                conn.request(method, path, body=data, headers=hdrs)
            except (http.client.HTTPException, OSError) as e:
                self._drop_conn()
                if reused and attempt == 0:
                    continue  # stale keep-alive socket; nothing was served
                raise ApiError(ErrorCode.UNAVAILABLE,
                               f"cannot reach API server: {e}") from None
            try:
                if self.faults is not None:
                    self.faults.on("http.recv", key=self.fault_key,
                                   exc=lambda m: OSError(m))
                resp = conn.getresponse()
                status, payload = resp.status, resp.read()
                if raised_timeout:  # keep-alive socket back to the default
                    conn.sock.settimeout(self.timeout)
                break
            except TimeoutError:
                # socket read timeout: the server (or an injected hang) is
                # holding the response past the transport's budget — the
                # client-side deadline. NOT retried here: the request may
                # be executing server-side; idempotent-verb retry is the
                # ApiClient RetryPolicy's call.
                self._drop_conn()
                budget = timeout_floor if raised_timeout else self.timeout
                raise ApiError(
                    ErrorCode.DEADLINE_EXCEEDED,
                    f"no response within the transport deadline "
                    f"({budget:.1f}s)") from None
            except (http.client.HTTPException, OSError) as e:
                self._drop_conn()
                if reused and attempt == 0 and method == "GET":
                    continue
                raise ApiError(
                    ErrorCode.UNAVAILABLE,
                    f"connection lost awaiting response: {e}") from None

        if status >= 400 and not allow_error_status:
            raise _error_from_payload(status, payload)
        try:
            return status, json.loads(payload or b"{}")
        except ValueError as e:
            raise ApiError(ErrorCode.UNAVAILABLE,
                           f"undecodable response body: {e}") from None

    def health(self) -> dict:
        """Health is special: a fully-down tier answers 503 with a valid
        health body (replica counts included), not an error envelope."""
        try:
            return self._request("GET", "/v1/health",
                                 allow_error_status=True)[1]
        except ApiError as e:
            return {"status": "down", "error": e.message,
                    **{k: v for k, v in e.details.items()}}

    # -- full v1 surface --------------------------------------------------
    def submit(self, api_key, req: SubmitRequest) -> SubmitResponse:
        body = {"manifest": dataclasses.asdict(req.manifest),
                "api_version": req.api_version}
        _, d = self._request("POST", "/v1/jobs", api_key, body=body,
                             headers={"Idempotency-Key": req.idempotency_key})
        return SubmitResponse(**d)

    def status(self, api_key, job_id, wait_ms=None,
               last_status=None) -> JobView:
        floor = None if not wait_ms else wait_ms / 1000.0 + 5.0
        _, d = self._request("GET", f"/v1/jobs/{job_id}", api_key,
                             query={"wait_ms": wait_ms,
                                    "last_status": last_status},
                             timeout_floor=floor)
        return JobView(**d)

    def status_history(self, api_key, job_id) -> list:
        _, d = self._request("GET", f"/v1/jobs/{job_id}/history", api_key)
        return [tuple(h) for h in d["items"]]

    def list_jobs(self, api_key, tenant=None, status=None, cursor=None,
                  limit=None) -> Page:
        _, d = self._request(
            "GET", "/v1/jobs", api_key,
            query={"tenant": tenant,
                   "status": getattr(status, "value", status),
                   "cursor": cursor, "limit": limit})
        return Page(items=[JobView(**v) for v in d["items"]],
                    next_cursor=d["next_cursor"])

    def logs(self, api_key, job_id, cursor=None, limit=None,
             wait_ms=None) -> Page:
        floor = None if not wait_ms else wait_ms / 1000.0 + 5.0
        _, d = self._request("GET", f"/v1/jobs/{job_id}/logs", api_key,
                             query={"cursor": cursor, "limit": limit,
                                    "wait_ms": wait_ms},
                             timeout_floor=floor)
        return Page(items=d["items"], next_cursor=d["next_cursor"])

    def search_logs(self, api_key, query, job_id=None, cursor=None,
                    limit=None) -> Page:
        _, d = self._request("GET", "/v1/logs/search", api_key,
                             query={"q": query, "job_id": job_id,
                                    "cursor": cursor, "limit": limit})
        return Page(items=[LogRecord(**r) for r in d["items"]],
                    next_cursor=d["next_cursor"])

    def halt(self, api_key, job_id, requeue: bool = False):
        self._request("POST", f"/v1/jobs/{job_id}/halt", api_key,
                      body={"requeue": requeue})

    def resume(self, api_key, job_id):
        self._request("POST", f"/v1/jobs/{job_id}/resume", api_key, body={})

    def cancel(self, api_key, job_id):
        self._request("DELETE", f"/v1/jobs/{job_id}", api_key)

    # -- observability plane ----------------------------------------------
    def usage(self, api_key, tenant=None) -> dict:
        _, d = self._request("GET", "/v1/usage", api_key,
                             query={"tenant": tenant})
        return {"items": d["items"]}

    def events(self, api_key, cursor=None, limit=None, kind=None,
               wait_ms=None) -> dict:
        floor = None if not wait_ms else wait_ms / 1000.0 + 5.0
        _, d = self._request("GET", "/v2/events", api_key,
                             query={"cursor": cursor, "limit": limit,
                                    "kind": kind, "wait_ms": wait_ms},
                             timeout_floor=floor)
        return {"items": d["items"], "next_cursor": d["next_cursor"],
                "missed": d.get("missed", 0)}

    # -- SSE streams ------------------------------------------------------
    def _stream(self, path: str, api_key: str,
                query: Optional[dict] = None,
                last_event_id: Optional[str] = None):
        """One SSE connection, yielded as parsed :class:`SseMessage`
        frames. Uses a dedicated (non-pooled) connection: the stream owns
        its socket for its whole life. Server-side error statuses raise
        the decoded ApiError; a route that answers with a non-SSE content
        type raises FAILED_PRECONDITION with ``sse_unsupported`` so
        callers can fall back to long-poll permanently."""
        with self._counters_lock:
            self.streams_opened += 1
        if query:
            qs = {k: v for k, v in query.items() if v is not None}
            if qs:
                path += "?" + urlparse.urlencode(qs)
        hdrs = {"Authorization": f"Bearer {api_key}",
                "Accept": SSE_CONTENT_TYPE}
        if last_event_id is not None:
            hdrs["Last-Event-ID"] = str(last_event_id)
        # read timeout must comfortably exceed the server's heartbeat
        # cadence — a silent stream is only dead if heartbeats stop too
        conn = http.client.HTTPConnection(
            self._host, self._port, timeout=max(self.timeout, 60.0))
        try:
            try:
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                conn.request("GET", path, headers=hdrs)
                resp = conn.getresponse()
            except (http.client.HTTPException, OSError) as e:
                raise ApiError(ErrorCode.UNAVAILABLE,
                               f"cannot open stream: {e}") from None
            if resp.status >= 400:
                raise _error_from_payload(resp.status, resp.read())
            ctype = resp.getheader("Content-Type") or ""
            if SSE_CONTENT_TYPE not in ctype:
                raise ApiError(ErrorCode.FAILED_PRECONDITION,
                               f"server answered {ctype!r}, not SSE",
                               sse_unsupported=True)
            try:
                # http.client decodes chunked transfer transparently
                yield from iter_sse(resp)
            except (http.client.HTTPException, OSError) as e:
                raise ApiError(ErrorCode.UNAVAILABLE,
                               f"stream lost: {e}") from None
        finally:
            conn.close()

    def stream_logs(self, api_key, job_id, cursor=None):
        return self._stream(f"/v1/jobs/{job_id}/logs", api_key,
                            query={"stream": "sse"}, last_event_id=cursor)

    def stream_status(self, api_key, job_id, last_status=None):
        return self._stream(f"/v1/jobs/{job_id}", api_key,
                            query={"stream": "sse"},
                            last_event_id=last_status)

    def stream_events(self, api_key, cursor=None, kind=None):
        return self._stream("/v2/events", api_key,
                            query={"stream": "sse", "kind": kind},
                            last_event_id=cursor)

    # -- v2 admin control plane -------------------------------------------
    # Same method names/signatures as the in-process AdminGateway, so
    # AdminClient (repro_torch.api.client) works over either transport.
    def create_tenant(self, api_key, body: dict) -> dict:
        return self._request("POST", "/v2/admin/tenants", api_key,
                             body=body)[1]

    def get_tenant(self, api_key, name: str) -> dict:
        return self._request("GET", f"/v2/admin/tenants/{name}", api_key)[1]

    def list_tenants(self, api_key) -> dict:
        return self._request("GET", "/v2/admin/tenants", api_key)[1]

    def patch_tenant(self, api_key, name: str, patch: dict) -> dict:
        return self._request("PATCH", f"/v2/admin/tenants/{name}", api_key,
                             body=patch)[1]

    def delete_tenant(self, api_key, name: str) -> dict:
        return self._request("DELETE", f"/v2/admin/tenants/{name}",
                             api_key)[1]

    def list_shards(self, api_key) -> dict:
        return self._request("GET", "/v2/admin/shards", api_key)[1]

    def get_shard(self, api_key, shard_id: str) -> dict:
        return self._request("GET", f"/v2/admin/shards/{shard_id}",
                             api_key)[1]

    def cordon_shard(self, api_key, shard_id: str) -> dict:
        return self._request("POST", f"/v2/admin/shards/{shard_id}/cordon",
                             api_key, body={})[1]

    def uncordon_shard(self, api_key, shard_id: str) -> dict:
        return self._request(
            "POST", f"/v2/admin/shards/{shard_id}/uncordon", api_key,
            body={})[1]

    def drain_shard(self, api_key, shard_id: str) -> dict:
        return self._request("POST", f"/v2/admin/shards/{shard_id}/drain",
                             api_key, body={})[1]

    def start_migration(self, api_key, body: dict) -> dict:
        return self._request("POST", "/v2/admin/migrations", api_key,
                             body=body)[1]

    def get_migration(self, api_key, migration_id: str) -> dict:
        return self._request("GET", f"/v2/admin/migrations/{migration_id}",
                             api_key)[1]

    def list_migrations(self, api_key) -> dict:
        return self._request("GET", "/v2/admin/migrations", api_key)[1]

    def operator_status(self, api_key) -> dict:
        return self._request("GET", "/v2/admin/operator", api_key)[1]

    def start_rollout(self, api_key, body: dict) -> dict:
        return self._request("POST", "/v2/admin/operator/rollout", api_key,
                             body=body)[1]

    def install_fault(self, api_key, body: dict) -> dict:
        return self._request("POST", "/v2/admin/faults", api_key,
                             body=body)[1]

    def list_faults(self, api_key) -> dict:
        return self._request("GET", "/v2/admin/faults", api_key)[1]

    def clear_faults(self, api_key, fault_id: Optional[str] = None) -> dict:
        path = ("/v2/admin/faults" if fault_id is None
                else f"/v2/admin/faults/{fault_id}")
        return self._request("DELETE", path, api_key)[1]

    # -- v2 workloads plane -----------------------------------------------
    # Same method names/signatures as the in-process WorkloadGateway, so
    # WorkloadClient (repro_torch.api.client) works over either transport.
    def apply(self, api_key, manifest) -> dict:
        body = ({"manifest_text": manifest} if isinstance(manifest, str)
                else {"manifest": manifest})
        return self._request("POST", "/v2/workloads", api_key,
                             body=body)[1]

    def get_workload(self, api_key, name: str, tenant=None) -> dict:
        return self._request("GET", f"/v2/workloads/{name}", api_key,
                             query={"tenant": tenant})[1]

    def list_workloads(self, api_key, tenant=None) -> dict:
        return self._request("GET", "/v2/workloads", api_key,
                             query={"tenant": tenant})[1]

    def delete_workload(self, api_key, name: str, tenant=None) -> dict:
        return self._request("DELETE", f"/v2/workloads/{name}", api_key,
                             query={"tenant": tenant})[1]

    def invoke_workload(self, api_key, name: str, payload=None,
                        tenant=None) -> dict:
        return self._request("POST", f"/v2/workloads/{name}/invoke",
                             api_key, query={"tenant": tenant},
                             body={"payload": payload})[1]
