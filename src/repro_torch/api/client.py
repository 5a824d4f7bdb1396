"""Tenant-scoped convenience client over any v1 transport.

``ApiClient`` binds an API key to a *transport* — anything exposing the
nine v1 verbs with ``(api_key, ...)`` signatures: the in-process
``LoadBalancer``, a single ``ApiGateway`` replica, a ``RateLimitedApi``
front, or :class:`repro_torch.api.http.HttpTransport` for a remote server.
The same calling code therefore works in-process and over the wire.

It replaces the retired ``FfDLPlatform.submit/status/...`` facade with the
same ergonomic return shapes (job ids, ``JobStatus``, plain lists) but the
v1 error contract: every failure is an ``ApiError`` with a stable code —
never a raw ``KeyError``/``ValueError``/``PermissionError``.

Streaming: when the transport exposes SSE (``stream_logs`` /
``stream_status`` / ``stream_events`` — :class:`HttpTransport` does,
in-process transports don't), ``follow_logs``/``watch_status``/
``follow_events`` ride ONE server-sent-events connection with heartbeats
instead of a long-poll request train. A dropped stream reconnects from its
``Last-Event-ID`` (exact resume, no replay and no gap) after a *jittered
exponential backoff* — a fleet of followers dropped by one API restart
must not stampede back in lockstep. A server without SSE
(``sse_unsupported``) demotes the client to long-poll permanently.
``prefer_sse=False`` forces long-poll (the ``--long-poll`` CLI flag).

Retries: an optional :class:`RetryPolicy` makes the *idempotent read
verbs* (status/history/list/logs/search/usage/events) retry transient
failures (``UNAVAILABLE``, ``DEADLINE_EXCEEDED``) with capped
exponential backoff and full jitter, honouring a server-supplied
``retry_after`` hint as the floor. Mutating verbs are never retried by
the policy — ``submit`` dedup rides idempotency keys, and re-issuing
``halt``/``cancel`` is the caller's decision. Default is ``None``: no
behaviour change for existing callers.
"""

from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.api.auth import ALL_TENANTS, READ, WRITE
from repro_torch.api.types import ApiError, ErrorCode, JobView, Page, \
    SubmitRequest, SubmitResponse
from repro_torch.core.types import TERMINAL, JobManifest, JobStatus

# consecutive UNAVAILABLE stream (re)opens before giving up — a live
# server that keeps resetting streams is as unreachable as a dead one
_MAX_STREAM_FAILURES = 3

# reconnect backoff for dropped SSE streams (always on; first retry is
# near-immediate so a one-off drop costs ~nothing)
_STREAM_BACKOFF_BASE_S = 0.05
_STREAM_BACKOFF_CAP_S = 2.0


def _backoff_s(attempt: int, retry_after, rng: random.Random,
               base_s: float, cap_s: float) -> float:
    """Capped exponential backoff with **full jitter** (uniform over
    [0, min(cap, base·2^attempt)]), floored at the server's
    ``Retry-After`` hint when one was sent — the server knows its own
    recovery horizon better than the client's doubling schedule."""
    ceiling = min(cap_s, base_s * (2 ** attempt))
    delay = rng.uniform(0.0, ceiling)
    if retry_after is not None:
        try:
            delay = max(delay, float(retry_after))
        except (TypeError, ValueError):
            pass
    return delay


@dataclass
class RetryPolicy:
    """Client-side retry budget for idempotent reads (opt-in)."""
    max_attempts: int = 4
    base_s: float = 0.05
    cap_s: float = 2.0
    seed: int = 0
    codes: tuple = (ErrorCode.UNAVAILABLE, ErrorCode.DEADLINE_EXCEEDED)
    rng: random.Random = field(init=False, repr=False)

    def __post_init__(self):
        self.rng = random.Random(self.seed)


def _frame_error(data) -> ApiError:
    """Decode an ``event: error`` frame (the standard wire error envelope
    delivered in-stream) back into the ApiError it carries."""
    try:
        wire = json.loads(data)["error"]
        code = ErrorCode(wire["code"])
        details = {k: v for k, v in wire.items()
                   if k not in ("code", "message")}
        return ApiError(code, wire.get("message", ""), **details)
    except (ValueError, KeyError, TypeError):
        return ApiError(ErrorCode.UNAVAILABLE,
                        f"undecodable stream error frame: {data!r}")


class ApiClient:
    def __init__(self, transport, api_key: str, prefer_sse: bool = True,
                 retry: Optional[RetryPolicy] = None):
        self.transport = transport
        self.api_key = api_key
        self.prefer_sse = prefer_sse
        self.retry = retry
        self._stream_rng = random.Random(0xF501)

    def _sse(self, verb: str) -> bool:
        return self.prefer_sse and hasattr(self.transport, verb)

    def _read(self, fn, *args, **kwargs):
        """Run an idempotent read verb under the retry policy (when one
        is configured): transient codes are retried with jittered
        exponential backoff, anything else propagates immediately."""
        pol = self.retry
        if pol is None:
            return fn(*args, **kwargs)
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except ApiError as e:
                attempt += 1
                if e.code not in pol.codes or attempt >= pol.max_attempts:
                    raise
                time.sleep(_backoff_s(attempt - 1,
                                      e.details.get("retry_after"),
                                      pol.rng, pol.base_s, pol.cap_s))

    def _stream_backoff(self, failures: int, err: ApiError):
        """Pause before reopening a dropped SSE stream (jittered, capped,
        Retry-After-aware) so reconnecting followers don't stampede."""
        time.sleep(_backoff_s(max(0, failures - 1),
                              err.details.get("retry_after"),
                              self._stream_rng,
                              _STREAM_BACKOFF_BASE_S,
                              _STREAM_BACKOFF_CAP_S))

    @classmethod
    def for_platform(cls, platform, tenant: str = ALL_TENANTS,
                     scopes: tuple = (READ, WRITE)) -> "ApiClient":
        """Mint a key for ``tenant`` and bind it to the platform's load
        balancer. The default ``"*"`` tenant is an operator credential —
        tests/ops tooling; real tenants should pass their own name."""
        return cls(platform.api, platform.auth.issue_key(tenant, scopes))

    # -- submit -----------------------------------------------------------
    def submit(self, manifest: JobManifest,
               idempotency_key: Optional[str] = None) -> str:
        """Durable-before-ack submit; returns the job id. Use
        :meth:`submit_envelope` when the ``deduplicated`` flag matters."""
        return self.submit_envelope(manifest, idempotency_key).job_id

    def submit_envelope(self, manifest: JobManifest,
                        idempotency_key: Optional[str] = None
                        ) -> SubmitResponse:
        return self.transport.submit(
            self.api_key, SubmitRequest(manifest=manifest,
                                        idempotency_key=idempotency_key))

    # -- reads ------------------------------------------------------------
    def status(self, job_id: str) -> JobStatus:
        return JobStatus(
            self._read(self.transport.status,
                       self.api_key, job_id).status)

    def view(self, job_id: str):
        """The full tenant-visible ``JobView`` projection."""
        return self._read(self.transport.status, self.api_key, job_id)

    def status_history(self, job_id: str) -> list:
        return self._read(self.transport.status_history,
                          self.api_key, job_id)

    def watch_status(self, job_id: str, wait_ms: int = 8000):
        """Yield the job's ``JobView`` once now and again on every status
        change until the job reaches a terminal state — the engine behind
        ``ffdl status --watch``. Rides one SSE connection when the
        transport streams; otherwise long-polls (bounded ``wait_ms`` per
        call, parked off-lock server-side)."""
        last = None
        if self._sse("stream_status"):
            failures = 0
            while True:
                ended = False
                try:
                    for fr in self.transport.stream_status(
                            self.api_key, job_id, last_status=last):
                        if fr.comment is not None:
                            continue
                        if fr.event == "end":
                            ended = True
                            break
                        if fr.event == "error":
                            raise _frame_error(fr.data)
                        failures = 0
                        view = JobView(**json.loads(fr.data))
                        last = fr.id or view.status
                        yield view
                except ApiError as e:
                    if e.details.get("sse_unsupported"):
                        break  # server can't stream: long-poll forever
                    failures += 1
                    if e.code is not ErrorCode.UNAVAILABLE \
                            or failures >= _MAX_STREAM_FAILURES:
                        raise
                    self._stream_backoff(failures, e)
                else:
                    if ended:
                        return
                    # clean close (stream budget spent): resume from last
        while True:
            view = self._read(self.transport.status, self.api_key, job_id,
                              wait_ms=wait_ms, last_status=last)
            if view.status != last:
                yield view
            last = view.status
            if JobStatus(view.status) in TERMINAL:
                return

    def list_jobs(self, **kwargs) -> Page:
        return self._read(self.transport.list_jobs, self.api_key, **kwargs)

    def logs(self, job_id: str, cursor: Optional[str] = None,
             limit: Optional[int] = None) -> list:
        """All log lines (auto-paginates when the transport pages)."""
        if limit is not None:
            return self._read(self.transport.logs, self.api_key, job_id,
                              cursor=cursor, limit=limit).items
        out, cur = [], cursor
        while True:
            page = self._read(self.transport.logs, self.api_key, job_id,
                              cursor=cur)
            out += page.items
            cur = page.next_cursor
            if cur is None:
                return out

    def follow_logs(self, job_id: str, cursor: Optional[str] = None,
                    wait_ms: int = 8000):
        """Yield log lines as they appear until the job reaches a terminal
        state and the stream is fully consumed — the engine behind
        ``ffdl logs --follow``. One SSE connection when the transport
        streams (every frame id is the exact resume cursor); long-poll on
        the server-side cursor otherwise."""
        if self._sse("stream_logs"):
            failures = 0
            while True:
                ended = False
                try:
                    for fr in self.transport.stream_logs(
                            self.api_key, job_id, cursor=cursor):
                        if fr.comment is not None:
                            continue
                        if fr.event == "end":
                            ended = True
                            break
                        if fr.event == "error":
                            raise _frame_error(fr.data)
                        failures = 0
                        if fr.id is not None:
                            cursor = fr.id
                        yield json.loads(fr.data)
                except ApiError as e:
                    if e.details.get("sse_unsupported"):
                        break
                    failures += 1
                    if e.code is not ErrorCode.UNAVAILABLE \
                            or failures >= _MAX_STREAM_FAILURES:
                        raise
                    self._stream_backoff(failures, e)
                else:
                    if ended:
                        return
        while True:
            page = self._read(self.transport.logs, self.api_key, job_id,
                              cursor=cursor, wait_ms=wait_ms)
            yield from page.items
            cursor = page.next_cursor
            if cursor is None:
                return

    def search_logs(self, query: str, job_id: Optional[str] = None,
                    cursor: Optional[str] = None,
                    limit: Optional[int] = None) -> list:
        """All matches (auto-paginates, like :meth:`logs`); with ``limit``
        set, exactly one page of at most that many records."""
        if limit is not None:
            return self._read(self.transport.search_logs,
                self.api_key, query, job_id=job_id, cursor=cursor,
                limit=limit).items
        out, cur = [], cursor
        while True:
            page = self._read(self.transport.search_logs, self.api_key,
                              query, job_id=job_id, cursor=cur)
            out += page.items
            cur = page.next_cursor
            if cur is None:
                return out

    # -- lifecycle writes -------------------------------------------------
    def halt(self, job_id: str, requeue: bool = False):
        return self.transport.halt(self.api_key, job_id, requeue=requeue)

    def resume(self, job_id: str):
        return self.transport.resume(self.api_key, job_id)

    def cancel(self, job_id: str):
        return self.transport.cancel(self.api_key, job_id)

    # -- observability plane ----------------------------------------------
    def usage(self, tenant: Optional[str] = None) -> list:
        """Per-tenant usage rows (chip-seconds, job counts, log bytes,
        429s). A tenant key reads its own row; an admin key reads all
        tenants (or one, with ``tenant=``)."""
        return self._read(self.transport.usage, self.api_key,
                          tenant=tenant)["items"]

    def events(self, cursor: Optional[str] = None,
               limit: Optional[int] = None, kind: Optional[str] = None,
               wait_ms: Optional[int] = None) -> dict:
        """One page of the platform event stream:
        ``{"items", "next_cursor", "missed"}``. The cursor chain serves
        every retained event exactly once; ``missed`` counts events that
        aged out of retention before this page read them."""
        return self._read(self.transport.events, self.api_key,
                          cursor=cursor, limit=limit, kind=kind,
                          wait_ms=wait_ms)

    def follow_events(self, cursor: Optional[str] = None,
                      kind: Optional[str] = None, wait_ms: int = 8000):
        """Yield platform events as they happen — the engine behind
        ``ffdl events --follow``. The stream has no natural end; iterate
        until done and close the generator. SSE when the transport
        streams, long-poll otherwise."""
        if self._sse("stream_events"):
            failures = 0
            while True:
                try:
                    for fr in self.transport.stream_events(
                            self.api_key, cursor=cursor, kind=kind):
                        if fr.comment is not None:
                            continue
                        if fr.event == "end":
                            return
                        if fr.event == "error":
                            raise _frame_error(fr.data)
                        failures = 0
                        if fr.id is not None:
                            cursor = fr.id
                        yield json.loads(fr.data)
                except ApiError as e:
                    if e.details.get("sse_unsupported"):
                        break
                    failures += 1
                    if e.code is not ErrorCode.UNAVAILABLE \
                            or failures >= _MAX_STREAM_FAILURES:
                        raise
                    self._stream_backoff(failures, e)
                # clean close: reconnect from the last delivered id
        while True:
            out = self._read(self.transport.events, self.api_key,
                             cursor=cursor, kind=kind, wait_ms=wait_ms)
            yield from out["items"]
            cursor = out["next_cursor"]


class AdminClient:
    """Operator-key convenience client for the v2 admin control plane.

    ``transport`` is anything exposing the fifteen v2 admin verbs with
    ``(api_key, ...)`` signatures: the in-process
    :class:`~repro_torch.api.admin.AdminGateway` (``platform.admin_api`` /
    ``federation.admin_api``) or an
    :class:`~repro_torch.api.http.HttpTransport`. Verbs return the wire
    dicts verbatim (``"api_version": "v2"`` envelopes).
    """

    def __init__(self, transport, api_key: str):
        self.transport = transport
        self.api_key = api_key

    @classmethod
    def for_platform(cls, platform) -> "AdminClient":
        """Mint an operator key with the ``admin`` scope and bind it to
        the platform's (or federation's) in-process admin gateway."""
        return cls(platform.admin_api, platform.auth.issue_admin_key())

    # -- tenants ----------------------------------------------------------
    def create_tenant(self, name: str, **fields) -> dict:
        return self.transport.create_tenant(self.api_key,
                                            {"name": name, **fields})

    def get_tenant(self, name: str) -> dict:
        return self.transport.get_tenant(self.api_key, name)

    def list_tenants(self) -> list:
        return self.transport.list_tenants(self.api_key)["items"]

    def patch_tenant(self, name: str, **fields) -> dict:
        return self.transport.patch_tenant(self.api_key, name, fields)

    def delete_tenant(self, name: str) -> dict:
        return self.transport.delete_tenant(self.api_key, name)

    # -- shards -----------------------------------------------------------
    def list_shards(self) -> list:
        return self.transport.list_shards(self.api_key)["items"]

    def get_shard(self, shard_id: str) -> dict:
        return self.transport.get_shard(self.api_key, shard_id)

    def cordon(self, shard_id: str) -> dict:
        return self.transport.cordon_shard(self.api_key, shard_id)

    def uncordon(self, shard_id: str) -> dict:
        return self.transport.uncordon_shard(self.api_key, shard_id)

    def drain(self, shard_id: str) -> dict:
        return self.transport.drain_shard(self.api_key, shard_id)

    # -- migrations -------------------------------------------------------
    def migrate(self, tenant: str, to_shard: str) -> dict:
        return self.transport.start_migration(
            self.api_key, {"tenant": tenant, "to_shard": to_shard})

    def migration(self, migration_id: str) -> dict:
        return self.transport.get_migration(self.api_key, migration_id)

    def list_migrations(self) -> list:
        return self.transport.list_migrations(self.api_key)["items"]

    # -- fault injection ---------------------------------------------------
    def install_fault(self, point: str, **fields) -> dict:
        """Install a fault plan on a named interposition point (e.g.
        ``install_fault("wal.flush", latency_s=2.0)``)."""
        return self.transport.install_fault(self.api_key,
                                            {"point": point, **fields})

    def list_faults(self) -> dict:
        return self.transport.list_faults(self.api_key)

    def clear_faults(self, fault_id: Optional[str] = None) -> dict:
        return self.transport.clear_faults(self.api_key, fault_id)

    # -- autonomous operator ----------------------------------------------
    def operator_status(self) -> dict:
        return self.transport.operator_status(self.api_key)

    def rollout(self, version: str) -> dict:
        """Start a GUARD-style rolling shard upgrade to ``version``."""
        return self.transport.start_rollout(self.api_key,
                                            {"version": version})


class WorkloadClient:
    """Convenience client for the v2 workloads plane (tenant- or
    admin-keyed).

    ``transport`` is anything exposing the five workload verbs with
    ``(api_key, ...)`` signatures: the in-process
    :class:`~repro_torch.workloads.plane.WorkloadGateway`
    (``platform.workloads_api`` / ``federation.workloads_api``) or an
    :class:`~repro_torch.api.http.HttpTransport`. Verbs return the wire
    dicts verbatim (``"api_version": "v2"`` envelopes).
    """

    def __init__(self, transport, api_key: str):
        self.transport = transport
        self.api_key = api_key

    @classmethod
    def for_platform(cls, platform, tenant: Optional[str] = None
                     ) -> "WorkloadClient":
        """Bind to the platform's (or federation's) in-process workloads
        gateway: a tenant key when ``tenant`` is given, else an admin
        key."""
        key = (platform.auth.issue_key(tenant) if tenant is not None
               else platform.auth.issue_admin_key())
        return cls(platform.workloads_api, key)

    def apply(self, manifest) -> dict:
        """Apply one manifest: a dict, or JSON / YAML-subset text."""
        return self.transport.apply(self.api_key, manifest)

    def get(self, name: str, tenant: Optional[str] = None) -> dict:
        return self.transport.get_workload(self.api_key, name,
                                           tenant=tenant)

    def list(self, tenant: Optional[str] = None) -> list:
        return self.transport.list_workloads(self.api_key,
                                             tenant=tenant)["items"]

    def delete(self, name: str, tenant: Optional[str] = None) -> dict:
        return self.transport.delete_workload(self.api_key, name,
                                              tenant=tenant)

    def invoke(self, name: str, payload=None,
               tenant: Optional[str] = None) -> dict:
        """One inference request against a RUNNING Service."""
        return self.transport.invoke_workload(self.api_key, name,
                                              payload=payload,
                                              tenant=tenant)
