"""ApiGateway: one stateless API-tier replica over routed shards (FfDL §3.2).

"The API layer stores all the metadata in MongoDB before acknowledging the
request" — and the tier itself is a set of replicated, stateless REST
services in front of *independently scalable* backends (the paper shards
its MongoDB metastore and scales each microservice on its own). Each
:class:`ApiGateway` instance is one such replica; it holds **no** platform
of its own. Instead every v1 verb:

  1. authenticates the caller (shared :class:`AuthService`);
  2. resolves the caller's shard through the :class:`TenantRouter`
     (hash-by-tenant, pin-table override) — a dead shard answers
     ``UNAVAILABLE`` for *its* tenants only, before any side effect;
  3. takes **that shard's** lock — read verbs (``status``, ``list_jobs``,
     ``logs``, ``search_logs``, ``status_history``) share a reader lock,
     write verbs (``submit``, ``halt``, ``resume``, ``cancel``) take it
     exclusively. A read on shard A never serializes behind a submit on
     shard B, replacing the old single global ``server.lock``.

Cross-shard surfaces stay contract-compatible: an admin ``list_jobs`` (and
admin log search) over a multi-shard federation merges per-shard pages
behind a composite cursor (see :mod:`repro_torch.api.router`); on a single shard
the wire cursors are byte-identical to the pre-federation ones. Replicas
stay individually crashable (``crash()``/``restart()``) and the
``LoadBalancer`` masks them exactly as before.

``logs`` additionally supports a bounded long-poll (``wait_ms``, capped at
10s): when the cursor is at the end of the stream, the call parks —
WITHOUT holding the shard lock — until new lines land or the job goes
terminal, which is what ``ffdl logs --follow`` rides on. ``status``
supports the same machinery for watching (``wait_ms`` + ``last_status``:
park until the status changes), behind ``ffdl status --watch``.
"""

from __future__ import annotations

import functools
import inspect
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict
from typing import Optional

from repro_torch.api.auth import AuthService, Principal, READ, WRITE
from repro_torch.api.router import (
    JOB_CURSOR_RE,
    OFFSET_CURSOR_RE,
    TenantRouter,
    encode_composite_cursor,
    parse_composite_cursor,
)
from repro_torch.api.types import (
    ApiError,
    ErrorCode,
    JobView,
    Page,
    SubmitRequest,
    SubmitResponse,
    check_version,
)
from repro_torch.core.faults import DeadlineExceeded, deadline_scope
from repro_torch.core.types import (
    TRAIN_SPEC_FIELDS,
    JobStatus,
    TERMINAL,
    gang_chips,
    unknown_spec_fields,
)
from repro_torch.obs import UsageMeter, event_to_wire

DEFAULT_PAGE = 20
# /v2/events default page size (its own knob: event pages are cheap —
# no metastore projection — so the default is bigger than DEFAULT_PAGE)
DEFAULT_EVENTS_PAGE = 100
# Upper bound on any page size: one tenant must not be able to drag the
# whole metastore/log index through a single call (multi-tenant fairness).
MAX_PAGE = 1000
# logs long-poll: hard server-side cap on how long one call may park, and
# how often a parked call re-checks the (lock-free-released) shard.
MAX_WAIT_MS = 10_000
_POLL_S = 0.02
# Per-verb deadline budget (seconds). Every v1 verb runs inside a
# repro_torch.core.faults.deadline_scope of this much (plus the caller's
# wait_ms for long-poll verbs): lock waits, injected latency, and
# injected hangs all observe it, so no request can block past its
# budget — a wedged shard answers DEADLINE_EXCEEDED instead of
# stalling the caller. Generous by default (normal verbs finish in
# microseconds-to-milliseconds); gray-failure drills tighten it.
DEFAULT_VERB_BUDGET_S = 10.0

# Which backend this thread's in-flight verb touched, for breaker
# outcome attribution when the deadline fires mid-verb.
_VERB_TLS = threading.local()


def _deadlined(fn):
    """Wrap a public v1 verb in a deadline scope + breaker accounting.

    On :class:`DeadlineExceeded` the touched shard's breaker records a
    failure and the caller gets the stable ``DEADLINE_EXCEEDED`` code
    (HTTP 504). NOT LB-retryable: every replica fronts the same shard,
    so failing over would just burn another full budget. A normal
    return records a breaker success; other ApiErrors are neutral (the
    shard answered — promptly — even if the answer was an error)."""
    sig = inspect.signature(fn)
    has_wait = "wait_ms" in sig.parameters
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        wait_s = 0.0
        if has_wait:
            try:
                bound = sig.bind(self, *args, **kwargs)
                w = bound.arguments.get("wait_ms")
                if isinstance(w, int) and not isinstance(w, bool) and w > 0:
                    wait_s = min(w, MAX_WAIT_MS) / 1000.0
            except TypeError:
                pass  # let fn raise its own signature error
        budget = self.verb_budget_s + wait_s
        _VERB_TLS.backend = None
        try:
            with deadline_scope(budget):
                plane = self._fault_plane()
                if plane is not None:
                    plane.on("gateway.dispatch", key=name,
                             exc=lambda m: ApiError(ErrorCode.UNAVAILABLE,
                                                    m, injected=True))
                out = fn(self, *args, **kwargs)
        except DeadlineExceeded:
            backend = getattr(_VERB_TLS, "backend", None)
            details = {"verb": name, "budget_s": round(budget, 3)}
            if backend is not None:
                backend.breaker.record_failure(deadline=True)
                details["shard"] = backend.shard_id
            raise ApiError(ErrorCode.DEADLINE_EXCEEDED,
                           f"{name} exceeded its {budget:.2f}s deadline "
                           f"budget", **details)
        backend = getattr(_VERB_TLS, "backend", None)
        if backend is not None:
            backend.breaker.record_success()
        return out
    return wrapper


def _parse_limit(limit):
    """Page sizes must be positive; 0/negative would corrupt cursors
    (skipped records, non-advancing pagination loops). Oversized pages are
    rejected rather than clamped so clients learn the real contract."""
    if limit is not None and (not isinstance(limit, int) or limit < 1):
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"limit must be a positive integer, got {limit!r}")
    if limit is not None and limit > MAX_PAGE:
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"limit {limit} exceeds maximum page size {MAX_PAGE}")
    return limit


def _parse_job_cursor(cursor):
    """list_jobs cursors are job ids minted by jobs_page; anything else
    would silently compare lexically against real ids and return an empty
    listing — reject it with the stable code instead."""
    if cursor is not None and not re.fullmatch(r"job-\d+", str(cursor)):
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"malformed cursor: {cursor!r}")
    return cursor


def _parse_cursor(cursor) -> int:
    """Offset cursors are opaque to clients; reject anything malformed
    with a stable code instead of leaking a raw ValueError."""
    if cursor is None:
        return 0
    try:
        n = int(cursor)
    except (TypeError, ValueError):
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"malformed cursor: {cursor!r}")
    if n < 0:
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"malformed cursor: {cursor!r}")
    return n


def _parse_wait_ms(wait_ms) -> int:
    """Long-poll budget: a non-negative integer, capped at MAX_WAIT_MS so
    one parked call can never pin a handler thread indefinitely."""
    if wait_ms is None:
        return 0
    if not isinstance(wait_ms, int) or isinstance(wait_ms, bool) \
            or wait_ms < 0:
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"wait_ms must be a non-negative integer, "
                       f"got {wait_ms!r}")
    return min(wait_ms, MAX_WAIT_MS)


def _parse_last_status(last_status) -> Optional[JobStatus]:
    """The status the watcher has already seen; anything that is not a
    JobStatus value would park forever (it can never equal the record)."""
    if last_status is None:
        return None
    try:
        return JobStatus(last_status)
    except ValueError:
        raise ApiError(ErrorCode.INVALID_ARGUMENT,
                       f"unknown status {last_status!r}")


@contextmanager
def _meta_guard():
    """Translate metastore outages into the stable UNAVAILABLE code."""
    try:
        yield
    except ConnectionError as e:
        raise ApiError(ErrorCode.UNAVAILABLE, str(e) or "metastore down")


def _shard_down(backend) -> ApiError:
    """A dead shard is UNAVAILABLE for its tenants only. ``shard_down``
    tells the LoadBalancer not to burn failovers on it: every replica
    routes the tenant to the same dead shard, unlike a dead replica."""
    return ApiError(ErrorCode.UNAVAILABLE,
                    f"shard {backend.shard_id} is down",
                    shard=backend.shard_id, shard_down=True)


def _breaker_open(backend) -> ApiError:
    """A gray-failed (wedged-but-alive) shard is quarantined exactly like
    a dead one: fast UNAVAILABLE with ``shard_down`` so the LB does not
    burn failovers, plus ``breaker_open`` so clients/operators can tell
    quarantine from crash. ``retry_after`` hints the half-open probe
    cadence."""
    return ApiError(ErrorCode.UNAVAILABLE,
                    f"shard {backend.shard_id} is quarantined "
                    f"(circuit breaker open)",
                    shard=backend.shard_id, shard_down=True,
                    breaker_open=True, retry_after=1.0)


class ApiGateway:
    # per-verb deadline budget; instances may tighten it (drills do)
    verb_budget_s = DEFAULT_VERB_BUDGET_S

    def __init__(self, router: TenantRouter, auth: AuthService,
                 replica_id: str = "api-0", events=None):
        self.router = router
        self.auth = auth
        self.replica_id = replica_id
        self.event_log = events  # the owning shard's bus (verb `events` differs)
        self.alive = True

    def _fault_plane(self):
        """The fleet-wide FaultPlane (every shard of a federation shares
        one; a standalone platform owns its own)."""
        backends = self.router.backends
        if not backends:
            return None
        return getattr(backends[0].platform, "faults", None)

    # -- replica lifecycle (chaos) --------------------------------------
    def crash(self):
        self.alive = False
        if self.event_log is not None:
            self.event_log.emit("api", "replica_crashed",
                             replica=self.replica_id)

    def restart(self):
        self.alive = True
        if self.event_log is not None:
            self.event_log.emit("api", "api_restarted", replica=self.replica_id)

    def _require(self, api_key: str, scope: str) -> Principal:
        # Liveness first: a dead replica fails before touching any state.
        if not self.alive:
            raise ApiError(ErrorCode.UNAVAILABLE,
                           f"replica {self.replica_id} is down",
                           replica=self.replica_id)
        return self.auth.require(api_key, scope)

    # -- shard resolution -------------------------------------------------
    def _check_backend(self, backend):
        """Liveness + breaker gate, plus deadline-attribution note: every
        path that is about to touch a shard funnels through here."""
        if not backend.alive:
            raise _shard_down(backend)
        if not backend.breaker.allow():
            raise _breaker_open(backend)
        _VERB_TLS.backend = backend
        return backend

    def _shard_for(self, tenant: str):
        return self._check_backend(self.router.shard_for(tenant))

    def _sole_shard(self):
        return self._check_backend(self.router.backends[0])

    def _locate(self, principal: Principal, job_id: str):
        """The shard that owns ``job_id`` for this caller.

        A tenant key only ever looks on the tenant's own shard — a job id
        minted by another shard is NOT_FOUND for it, never data (tenant
        isolation holds across shards exactly as within one). An admin key
        scans shards (read-locking one at a time); a copy found on a shard
        the job's tenant is NOT routed to (the half-imported destination of
        a live migration) is skipped in favour of the routed source of
        truth. If the job is nowhere but some shard was down, the honest
        answer is UNAVAILABLE, not NOT_FOUND.
        """
        if not principal.is_admin:
            return self._shard_for(principal.tenant)
        dead = None
        unrouted_tenant = None
        for backend in self.router.backends:
            # a breaker-quarantined shard is skipped exactly like a dead
            # one: scanning it would wedge the whole admin walk
            if not backend.alive or not backend.breaker.allow():
                dead = backend
                continue
            _VERB_TLS.backend = backend
            with backend.read_locked(), _meta_guard():
                rec = backend.platform.meta.get(job_id)
            if rec is not None:
                if self.router.shard_for(rec.manifest.tenant) is backend:
                    return backend
                unrouted_tenant = rec.manifest.tenant
        if unrouted_tenant is not None:
            # only a mid-migration copy exists and its source of truth is
            # unreachable — never serve the stale import
            raise _shard_down(self.router.shard_for(unrouted_tenant))
        if dead is not None:
            raise (_shard_down(dead) if not dead.alive
                   else _breaker_open(dead))
        raise ApiError(ErrorCode.NOT_FOUND, f"no such job: {job_id}",
                       job_id=job_id)

    @contextmanager
    def _tenant_locked(self, tenant: str, write: bool = False):
        """The tenant's backend with its lock held AND the routing verified
        under that lock. A migration cutover flips the pin table while
        holding both shards' write locks, so a verb that resolved the old
        shard but acquired its lock only after the flip re-resolves — an
        in-flight request can never observe a half-moved tenant."""
        while True:
            backend = self._shard_for(tenant)
            ctx = (backend.write_locked() if write
                   else backend.read_locked())
            with ctx:
                if self.router.shard_for(tenant) is backend:
                    yield backend
                    return
            # pin flipped while we waited for the lock: retry on the new one

    @contextmanager
    def _job_locked(self, principal: Principal, job_id: str,
                    write: bool = False):
        """Locate + lock + ownership-check in one step, stable across a
        concurrent migration cutover (re-locates once if the record moved
        between resolution and lock acquisition)."""
        attempt = 0
        while True:
            backend = self._locate(principal, job_id)
            ctx = (backend.write_locked() if write
                   else backend.read_locked())
            with ctx:
                moved = (not principal.is_admin and
                         self.router.shard_for(principal.tenant)
                         is not backend)
                if not moved:
                    with _meta_guard():
                        rec = backend.platform.meta.get(job_id)
                    if rec is None and principal.is_admin and attempt == 0:
                        pass  # moved since the admin scan: re-scan once
                    else:
                        if rec is None:
                            raise ApiError(ErrorCode.NOT_FOUND,
                                           f"no such job: {job_id}",
                                           job_id=job_id)
                        if not principal.owns(rec.manifest.tenant):
                            raise ApiError(
                                ErrorCode.FORBIDDEN,
                                f"job {job_id} belongs to another tenant",
                                job_id=job_id)
                        yield backend, rec
                        return
            attempt += 1

    # -- submit ----------------------------------------------------------
    @_deadlined
    def submit(self, api_key: str, req: SubmitRequest) -> SubmitResponse:
        principal = self._require(api_key, WRITE)
        check_version(req.api_version)
        m = req.manifest
        if not principal.owns(m.tenant):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"key for tenant {principal.tenant!r} cannot "
                           f"submit as {m.tenant!r}")
        if m.n_learners < 1 or m.chips_per_learner < 0:
            raise ApiError(ErrorCode.INVALID_ARGUMENT, "invalid manifest")
        # Spec hygiene: an unknown train key would be silently ignored by
        # the learner runtime — reject it here (both transports funnel
        # through this verb) so manifest typos can't mask themselves.
        bad = unknown_spec_fields(m)
        if bad:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"unknown train spec fields: {bad} "
                           f"(known: {list(TRAIN_SPEC_FIELDS)})")
        # about to create records: if the tenant's hash shard is cordoned,
        # make the reroute sticky so an uncordon can't orphan the records
        self.router.pin_for_write(m.tenant)
        with self._tenant_locked(m.tenant, write=True) as backend:
            p = backend.platform
            if gang_chips(m) > p.cluster.total_chips:
                raise ApiError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"job needs {gang_chips(m)} chips; cluster has "
                    f"{p.cluster.total_chips}")
            with _meta_guard():
                if req.idempotency_key is not None:
                    existing = p.meta.find_idempotent(m.tenant,
                                                      req.idempotency_key)
                    if existing is not None:
                        # same key + different payload is a client bug:
                        # surface it instead of silently dropping the job
                        prior = p.meta.get(existing)
                        if prior is not None and \
                                asdict(prior.manifest) != asdict(m):
                            raise ApiError(
                                ErrorCode.CONFLICT,
                                f"idempotency key {req.idempotency_key!r} "
                                f"was already used for {existing} with a "
                                f"different manifest", job_id=existing)
                        p.events.emit("api", "submit_deduplicated",
                                      job=existing, tenant=m.tenant,
                                      replica=self.replica_id)
                        return SubmitResponse(job_id=existing,
                                              deduplicated=True)
                ok, why = p.admission.check(m)
                if not ok:
                    p.events.emit("api", "admission_rejected",
                                  tenant=m.tenant, reason=why)
                    raise ApiError(ErrorCode.QUOTA_EXCEEDED,
                                   f"admission denied: {why}")
                job_id = p._next_job_id()
                # durable BEFORE ack (idempotency rides the same WAL op)
                p.meta.insert_job(job_id, m,
                                  idempotency_key=req.idempotency_key)
                p.admission.mark(job_id, m)
            p.events.emit("api", "job_submitted", job=job_id,
                          tenant=m.tenant, replica=self.replica_id,
                          shard=backend.shard_id)
        return SubmitResponse(job_id=job_id)

    # -- reads -----------------------------------------------------------
    @_deadlined
    def status(self, api_key: str, job_id: str,
               wait_ms: Optional[int] = None,
               last_status: Optional[str] = None) -> JobView:
        """One job's JobView; with ``wait_ms`` + ``last_status``, a watch
        long-poll: the call parks — OFF the shard lock, same machinery as
        the logs long-poll — until the status differs from ``last_status``,
        the job goes terminal, or the budget runs out. ``ffdl status
        --watch`` / ``ApiClient.watch_status`` loop on exactly this."""
        principal = self._require(api_key, READ)
        last = _parse_last_status(last_status)
        deadline = time.monotonic() + _parse_wait_ms(wait_ms) / 1000.0
        while True:
            # re-resolve every round: a migration cutover may move the
            # tenant between polls, and a parked watcher must follow it
            with self._job_locked(principal, job_id) as (backend, rec):
                view = JobView.of(rec)  # project under the lock
                terminal = rec.status in TERMINAL
            if last is None or view.status != last.value or terminal \
                    or time.monotonic() >= deadline:
                return view
            # Park OUTSIDE the shard lock: a watcher must never block the
            # ticker (writer) or other readers while it waits.
            time.sleep(_POLL_S)

    @_deadlined
    def status_history(self, api_key: str, job_id: str) -> list:
        principal = self._require(api_key, READ)
        with self._job_locked(principal, job_id) as (_backend, rec):
            return list(rec.status_history)

    @_deadlined
    def list_jobs(self, api_key: str, tenant: Optional[str] = None,
                  status: Optional[JobStatus] = None,
                  cursor: Optional[str] = None,
                  limit: int = DEFAULT_PAGE) -> "Page[JobView]":
        principal = self._require(api_key, READ)
        if tenant is None:
            tenant = None if principal.is_admin else principal.tenant
        elif not principal.owns(tenant):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"cannot list jobs of tenant {tenant!r}")
        limit = _parse_limit(limit) or DEFAULT_PAGE
        if tenant is None and len(self.router.backends) > 1:
            return self._list_jobs_federated(status, cursor, limit)
        if tenant is not None:
            with self._tenant_locked(tenant) as backend, _meta_guard():
                recs, next_cursor = backend.platform.meta.jobs_page(
                    tenant=tenant, status=status,
                    cursor=_parse_job_cursor(cursor), limit=limit)
                # project INSIDE the lock: a concurrent tick may mutate the
                # records the moment we release it (torn status/finished_at)
                items = [JobView.of(r) for r in recs]
            return Page(items=items, next_cursor=next_cursor)
        backend = self._sole_shard()
        with backend.read_locked(), _meta_guard():
            recs, next_cursor = backend.platform.meta.jobs_page(
                tenant=tenant, status=status,
                cursor=_parse_job_cursor(cursor), limit=limit)
            items = [JobView.of(r) for r in recs]
        return Page(items=items, next_cursor=next_cursor)

    def _hidden_import(self, backend, tenant: str) -> bool:
        """True for records living on the DESTINATION shard of the
        tenant's live migration: the half-imported copy must stay
        invisible to cross-shard reads until cutover makes it the routed
        source of truth (otherwise an admin walk would serve the same job
        from both shards)."""
        return self.router.migration_target(tenant) == backend.shard_id

    def _mint_span(self, backend) -> tuple:
        """The id interval ``(lo, hi]`` (as job-id strings, ``hi`` None =
        unbounded) that ``backend`` mints from: ``job_id_base`` up to the
        next shard's base. Every job id belongs to exactly one shard's
        span, for life — even after a migration moves the record."""
        base = getattr(backend.platform, "job_id_base", 0)
        later = [b2 for b in self.router.backends
                 if (b2 := getattr(b.platform, "job_id_base", 0)) > base]
        hi = min(later) if later else None
        return (f"job-{base:05d}",
                None if hi is None else f"job-{hi:05d}")

    def _stream_page(self, owner, status, cursors, need: int) -> list:
        """One page of ``owner``'s minting-id stream: its span's records
        in id order, collected from EVERY shard (a migration may have
        moved them) past the stream's cursor. Half-imported destination
        copies are hidden (the source still serves the id); equal ids are
        deduped keeping the routed copy. Advances the stream cursor."""
        lo, hi = self._mint_span(owner)
        cur = cursors.get(owner.shard_id)
        best: dict = {}  # job_id -> (is_routed_copy, JobView)
        for backend in self.router.backends:
            # a partial admin listing would silently hide a shard's
            # tenants; fail honestly instead (dead OR quarantined)
            self._check_backend(backend)
            with backend.read_locked(), _meta_guard():
                for r in backend.platform.meta.jobs_span(
                        lo=lo, hi=hi, status=status, cursor=cur,
                        limit=need):
                    if self._hidden_import(backend, r.manifest.tenant):
                        continue
                    routed = self.router.shard_for(r.manifest.tenant) \
                        is backend
                    prev = best.get(r.job_id)
                    if prev is None or (routed and not prev[0]):
                        best[r.job_id] = (routed, JobView.of(r))
        page = [best[jid][1] for jid in sorted(best)[:need]]
        if page:
            cursors[owner.shard_id] = page[-1].job_id
        return page

    def _list_jobs_federated(self, status, cursor, limit: int) -> Page:
        """Admin all-tenant listing over >1 shard, merged behind a
        composite cursor with one entry per shard's **minting-id
        stream** — the contiguous id interval the shard mints from. A
        record belongs to its minting stream for life, wherever a
        migration moves it, so the stream cursor keeps meaning "every id
        up to here was served" across any number of cutovers: items never
        repeat and never go missing, even when a migration starts AND
        finishes between two pages of the walk. Submits that land
        mid-iteration on a still-open stream are served by a later page;
        a stream that answers an EMPTY page is marked exhausted in the
        cursor and never queried again for the rest of the walk — long
        admin walks stop paying one probe per drained shard per page."""
        cursors, exhausted = parse_composite_cursor(cursor, self.router,
                                                    JOB_CURSOR_RE)
        items: list = []
        for owner in self.router.backends:
            sid = owner.shard_id
            if sid in exhausted:
                continue
            if len(items) >= limit:
                break
            while len(items) < limit:
                need = limit - len(items)
                page = self._stream_page(owner, status, cursors, need)
                if not page:
                    exhausted.add(sid)  # final page already served
                    break
                items += page
                if len(page) < need:
                    break  # stream dry for NOW — stays open so submits
                    #        landing mid-iteration are served later
        next_cursor = (encode_composite_cursor(cursors, exhausted)
                       if len(items) == limit else None)
        return Page(items=items, next_cursor=next_cursor)

    @_deadlined
    def logs(self, api_key: str, job_id: str, cursor: Optional[str] = None,
             limit: Optional[int] = None,
             wait_ms: Optional[int] = None) -> "Page[str]":
        principal = self._require(api_key, READ)
        start = _parse_cursor(cursor)
        limit = _parse_limit(limit) or MAX_PAGE
        budget_s = _parse_wait_ms(wait_ms) / 1000.0
        deadline = time.monotonic() + budget_s
        while True:
            # re-resolve every round: a cutover may move the tenant while
            # a follower is parked; per-job log offsets survive the move,
            # so the SAME cursor keeps meaning the same line
            with self._job_locked(principal, job_id) as (backend, rec):
                # no limit means "a full page", never "the whole stream":
                # MAX_PAGE bounds every single call
                lines, next_off = backend.platform.log_index.stream_page(
                    job_id, cursor=start, limit=limit)
                terminal = rec.status in TERMINAL
            if lines or terminal or time.monotonic() >= deadline:
                break
            # Park OUTSIDE the shard lock: a long-poll must never block
            # the ticker (writer) or other readers while it waits.
            time.sleep(_POLL_S)
        if budget_s > 0:
            # Follow-mode cursor contract: next_cursor stays set (the
            # resume offset) until the job is terminal AND fully consumed,
            # so `logs --follow` can keep polling from it.
            done = terminal and next_off is None
            next_off = None if done else start + len(lines)
        return Page(items=lines,
                    next_cursor=None if next_off is None else str(next_off))

    @_deadlined
    def search_logs(self, api_key: str, query: str,
                    job_id: Optional[str] = None,
                    cursor: Optional[str] = None,
                    limit: Optional[int] = None) -> "Page":
        principal = self._require(api_key, READ)
        limit = _parse_limit(limit) or MAX_PAGE
        if job_id is None and principal.is_admin \
                and len(self.router.backends) > 1:
            return self._search_logs_federated(query, cursor, limit)
        start = _parse_cursor(cursor)
        if job_id is not None:
            with self._job_locked(principal, job_id) as (backend, _rec):
                recs, next_cursor = backend.platform.log_index.search_page(
                    query, job_id=job_id, cursor=start, limit=limit,
                    allow=None)
        elif principal.is_admin:
            backend = self._sole_shard()
            with backend.read_locked():
                recs, next_cursor = backend.platform.log_index.search_page(
                    query, job_id=None, cursor=start, limit=limit,
                    allow=None)
        else:
            with self._tenant_locked(principal.tenant) as backend:
                allow = self._tenant_filter(backend, principal)
                recs, next_cursor = backend.platform.log_index.search_page(
                    query, job_id=None, cursor=start, limit=limit,
                    allow=allow)
        return Page(items=recs,
                    next_cursor=None if next_cursor is None
                    else str(next_cursor))

    @staticmethod
    def _tenant_filter(backend, principal: Principal):
        tenant_of: dict = {}

        def allow(jid, _memo=tenant_of):
            if jid not in _memo:
                with _meta_guard():
                    rec = backend.platform.meta.get(jid)
                _memo[jid] = rec.manifest.tenant if rec else None
            return _memo[jid] == principal.tenant

        return allow

    def _fed_search_allow(self, backend):
        """Cross-shard search filter: hide lines of jobs this shard's
        metastore does not know (tombstoned leftovers) and of tenants
        whose live migration is importing INTO this shard (the half-moved
        copy — the routed source shard still serves those lines). The
        hidden set is computed ONCE per page, not per scanned record; the
        per-record check is then two dict probes. Caller holds the
        shard's read lock."""
        meta = backend.platform.meta
        with _meta_guard():
            meta._check()  # one availability check for the whole page
        hidden: set = set()
        for tenant in self.router.migrating_into(backend.shard_id):
            hidden.update(meta._by_tenant.get(tenant, ()))
        jobs = meta._jobs

        def allow(jid, _jobs=jobs, _hidden=hidden):
            return jid in _jobs and jid not in _hidden
        return allow

    def _search_logs_federated(self, query: str, cursor, limit: int) -> Page:
        """Admin all-shard log search: same composite-cursor merge (and
        exhausted-shard markers) as the federated listing, with per-shard
        append offsets as cursors."""
        cursors, exhausted = parse_composite_cursor(cursor, self.router,
                                                    OFFSET_CURSOR_RE)
        items: list = []
        for backend in self.router.backends:
            sid = backend.shard_id
            if sid in exhausted:
                continue
            if len(items) >= limit:
                break
            self._check_backend(backend)
            need = limit - len(items)
            with backend.read_locked():
                recs, next_off = backend.platform.log_index.search_page(
                    query, cursor=int(cursors.get(sid, 0)),
                    limit=need, allow=self._fed_search_allow(backend))
                if next_off is None:
                    # scanned to the end: remember how far, so records
                    # appended later are still found by a later page —
                    # and an EMPTY scan closes the shard for this walk
                    next_off = len(backend.platform.log_index.records)
                    if not recs:
                        exhausted.add(sid)
            cursors[sid] = str(next_off)
            items += recs
        next_cursor = (encode_composite_cursor(cursors, exhausted)
                       if len(items) == limit else None)
        return Page(items=items, next_cursor=next_cursor)

    # -- lifecycle writes -------------------------------------------------
    @_deadlined
    def halt(self, api_key: str, job_id: str, requeue: bool = False):
        principal = self._require(api_key, WRITE)
        with self._job_locked(principal, job_id, write=True) \
                as (backend, rec):
            # a late/retried halt must never rewrite a terminal record
            # (COMPLETED → HALTED would let resume() re-run a finished job)
            if rec.status in TERMINAL:
                raise ApiError(ErrorCode.FAILED_PRECONDITION,
                               f"{job_id} is already {rec.status.value}")
            with _meta_guard():
                backend.platform._halt_internal(job_id, requeue=requeue)

    @_deadlined
    def resume(self, api_key: str, job_id: str):
        principal = self._require(api_key, WRITE)
        with self._job_locked(principal, job_id, write=True) \
                as (backend, rec):
            if rec.status != JobStatus.HALTED:
                raise ApiError(ErrorCode.FAILED_PRECONDITION,
                               f"{job_id} is not HALTED")
            with _meta_guard():
                backend.platform._resume_internal(job_id)

    @_deadlined
    def cancel(self, api_key: str, job_id: str):
        principal = self._require(api_key, WRITE)
        with self._job_locked(principal, job_id, write=True) \
                as (backend, rec):
            if rec.status in TERMINAL:
                raise ApiError(ErrorCode.FAILED_PRECONDITION,
                               f"{job_id} is already {rec.status.value}")
            with _meta_guard():
                backend.platform._cancel_internal(job_id)

    # -- observability plane (repro_torch.obs) ----------------------------------
    @_deadlined
    def usage(self, api_key: str, tenant: Optional[str] = None) -> dict:
        """GET /v1/usage: per-tenant usage rows summed across every shard
        (a migrated tenant's history lives on both its shards' meters).
        A tenant key sees its own row; an admin key sees all tenants, or
        one with ``?tenant=``. Any dead shard fails the read — billing
        must never silently undercount."""
        principal = self._require(api_key, READ)
        if tenant is None:
            tenant = None if principal.is_admin else principal.tenant
        elif not principal.owns(tenant):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"cannot read usage of tenant {tenant!r}")
        snaps = []
        for backend in self.router.backends:
            self._check_backend(backend)
            with backend.read_locked():
                snaps.append(backend.platform.meter.snapshot())
        merged = UsageMeter.merge(snaps, tenant=tenant)
        if tenant is not None and tenant not in merged:
            merged[tenant] = UsageMeter().get(tenant)  # all-zero row
        items = [{"tenant": t,
                  **{f: (round(v, 3) if isinstance(v, float) else v)
                     for f, v in row.items()}}
                 for t, row in sorted(merged.items())]
        return {"items": items}

    @staticmethod
    def _parse_event_kind(kind):
        if kind is not None and (not isinstance(kind, str) or not kind):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"kind must be a non-empty string, got {kind!r}")
        return kind

    @_deadlined
    def events(self, api_key: str, cursor: Optional[str] = None,
               limit: Optional[int] = None, kind: Optional[str] = None,
               wait_ms: Optional[int] = None) -> dict:
        """GET /v2/events: cursor replay over the platform event stream.

        Exactly-once per shard over successful responses: each page's
        ``next_cursor`` continues precisely after the last sequence number
        the page consumed, so a seq is never served twice on one cursor
        chain, and retention drops are reported explicitly as ``missed``
        (never silently skipped). A tenant key reads its own shard's
        stream filtered to its own events; an admin key reads everything —
        across a federation, behind the same composite-cursor scheme as
        the other admin walks. ``next_cursor`` is ALWAYS present: the
        stream has no end. With ``wait_ms`` the call parks (off the shard
        lock) until an event matches, for ``events --follow``."""
        principal = self._require(api_key, READ)
        limit = _parse_limit(limit) or DEFAULT_EVENTS_PAGE
        kind = self._parse_event_kind(kind)
        deadline = time.monotonic() + _parse_wait_ms(wait_ms) / 1000.0
        multi = principal.is_admin and len(self.router.backends) > 1
        while True:
            if multi:
                out = self._events_federated(cursor, limit, kind)
            else:
                out = self._events_single(principal, cursor, limit, kind)
            if out["items"] or time.monotonic() >= deadline:
                return out
            cursor = out["next_cursor"]  # keep the scan's progress
            time.sleep(_POLL_S)

    def _events_single(self, principal: Principal, cursor, limit: int,
                       kind) -> dict:
        if principal.is_admin:
            backend = self._sole_shard()
            visible = None
        else:
            backend = self._shard_for(principal.tenant)
            tenant = principal.tenant
            # tenant isolation: ONLY events stamped with this tenant;
            # unstamped platform-internal events are admin-only
            visible = (lambda e, _t=tenant: e.tenant == _t)
        cur = _parse_cursor(cursor)
        with backend.read_locked():
            evs, nxt, missed = backend.platform.events.read_since(
                cur, limit, visible=visible, kind=kind)
            items = [event_to_wire(e, backend.shard_id) for e in evs]
        return {"items": items, "next_cursor": str(nxt), "missed": missed}

    def _events_federated(self, cursor, limit: int, kind) -> dict:
        """Admin event walk over >1 shard: shard-major fill behind a
        composite cursor (one integer seq per shard). No exhausted
        markers — an event stream never ends — so every response carries
        the full composite for the next poll."""
        cursors, _exhausted = parse_composite_cursor(cursor, self.router,
                                                     OFFSET_CURSOR_RE)
        items: list = []
        missed = 0
        for backend in self.router.backends:
            sid = backend.shard_id
            if len(items) >= limit:
                break
            # a partial admin stream would silently lose a shard's
            # events for this page; fail honestly, cursor unchanged
            self._check_backend(backend)
            need = limit - len(items)
            with backend.read_locked():
                evs, nxt, m = backend.platform.events.read_since(
                    int(cursors.get(sid, 0)), need, kind=kind)
                items += [event_to_wire(e, sid) for e in evs]
            cursors[sid] = str(nxt)
            missed += m
        return {"items": items,
                "next_cursor": encode_composite_cursor(cursors, set()),
                "missed": missed}
