"""The v2 admin control plane: tenants, shards, and migrations as wire
resources (FfDL §3-4; Boag et al. 2018; Saxena et al. 2020).

The port's copy of the reference's ``repro/api/admin.py``, unchanged.

FfDL's operators manage tenants, quotas, and cluster shards as first-class
platform objects, not as side effects of job verbs; the dependability
companion paper stresses operator-driven lifecycle actions as the main
lever for surviving faults, and the elastic-scaling work motivates moving
workloads between resource pools *without killing them*. This module is
that control plane for our reproduction:

  * **tenants** — create/get/list/patch/delete. A tenant resource carries
    its chip quota (registered with every shard's admission controller),
    its tier, an optional per-tenant rate-limit override (applied live to
    the HTTP tier's token buckets), and an optional shard pin;
  * **shards** — get/list with live occupancy (resident tenants, job
    counts, chips), plus cordon/uncordon and ``drain`` = migrate every
    resident tenant off, then cordon;
  * **migrations** — POST a tenant→shard move, GET its phase. The headline
    mechanism: a live rebalance through a four-phase state machine,

        SNAPSHOT  bulk-copy the tenant's metastore slice + logs while its
                  jobs keep running (WAL-consistent export at a journal
                  watermark);
        CATCHUP   re-export only the mutations that landed during the
                  copy; quiesce the tenant's running work through the
                  platform's own checkpoint-and-halt path (the same
                  machinery admission-control preemption uses);
        CUTOVER   under BOTH shards' write locks: final delta, move
                  volumes/checkpoints, purge the source, atomically flip
                  the pin table, resume the quiesced jobs on the
                  destination. No v1 verb can interleave, so in-flight
                  requests never observe a half-moved tenant — they
                  resolve the old shard before the locks or the new shard
                  after;
        DONE.

    Crash at any phase recovers to a consistent source-of-truth shard: a
    dead source or destination aborts the migration (``FAILED``), unlocks
    routing, resumes anything the quiesce halted back on the source, and
    purges the destination's partial import — either cleanup is deferred
    and retried every tick while its shard is down. Routing edits
    (``pin``/``unpin``) are frozen with ``FAILED_PRECONDITION`` while a
    tenant migrates.

Admin calls require an operator key carrying the ``admin`` scope
(``AuthService.issue_admin_key``); v2 envelopes are stamped
``"api_version": "v2"``. The v1 job data plane is bit-for-bit unchanged.
"""

from __future__ import annotations

import itertools
import threading
from collections import Counter
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from repro_torch.api.auth import ADMIN, AuthService, Principal
from repro_torch.api.ratelimit import RateLimitConfig
from repro_torch.api.types import (ADMIN_API_VERSION, ApiError, ErrorCode,
                             deadline_guarded)
from repro_torch.core.types import TERMINAL, JobStatus
from repro_torch.data.objectstore import ObjectStoreError


class MigrationPhase(str, Enum):
    SNAPSHOT = "SNAPSHOT"
    CATCHUP = "CATCHUP"
    CUTOVER = "CUTOVER"
    DONE = "DONE"
    FAILED = "FAILED"


LIVE_PHASES = {MigrationPhase.SNAPSHOT, MigrationPhase.CATCHUP,
               MigrationPhase.CUTOVER}


def _serialized(fn):
    """Every public AdminPlane verb under the plane mutex: admin verbs run
    on HTTP handler threads concurrently with the tick thread's advance(),
    and e.g. two simultaneous POST /v2/admin/migrations for one tenant
    must not both pass the lock_tenant check. Reentrant (drain calls
    start_migration). Ordering is always plane mutex -> shard lock, never
    the reverse, so this cannot deadlock against the v1 data plane."""
    def wrapper(self, *args, **kwargs):
        with self._mutex:
            return fn(self, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@dataclass
class TenantSpec:
    """The tenant resource (control-plane state, not derivable from jobs)."""

    name: str
    quota_chips: Optional[int] = None
    tier: str = "paid"
    rate: Optional[float] = None    # per-tenant rate-limit override
    burst: Optional[int] = None
    shard: Optional[str] = None     # explicit pin (None = hash-routed)
    created_at: float = 0.0


@dataclass
class Migration:
    """One tenant→shard move, addressable while (and after) it runs."""

    migration_id: str
    tenant: str
    from_shard: str
    to_shard: str
    phase: MigrationPhase = MigrationPhase.SNAPSHOT
    error: str = ""
    created_at: float = 0.0
    updated_at: float = 0.0
    wal_watermark: int = 0                 # source journal ops copied so far
    log_watermarks: Dict[str, int] = field(default_factory=dict)
    halted_jobs: List[str] = field(default_factory=list)  # quiesced by us
    stats: Dict[str, int] = field(default_factory=lambda: {
        "ops_copied": 0, "records_copied": 0, "log_lines_copied": 0,
        "volumes_moved": 0, "objects_copied": 0, "catchup_rounds": 0})


class AdminPlane:
    """Shared control-plane state + the migration state machine.

    One instance per federation (and per standalone platform — the
    1-shard case); every gateway replica's :class:`AdminGateway` fronts
    the same plane, like every v1 replica fronts the same router.
    ``advance()`` is called once per federation tick and performs at most
    one phase step per live migration, so tests can crash shards/replicas
    "mid-phase" deterministically.
    """

    def __init__(self, router, auth: AuthService):
        self.router = router
        self.auth = auth
        self.tenants: Dict[str, TenantSpec] = {}
        self.migrations: Dict[str, Migration] = {}
        self._mig_ctr = itertools.count(1)
        self.ratelimiter = None  # attached by ApiHttpServer when present
        self.operator = None     # attached by repro_torch.api.ops.install_operator
        self.faults = None       # attached by the platform/federation ctor
        # (shard_id, tenant) purges waiting for a dead destination to return
        self._deferred_purges: List[tuple] = []
        # (shard_id, [job_ids]) resumes waiting for a dead SOURCE to return
        # (jobs a migration quiesced must never be left HALTED forever)
        self._deferred_resumes: List[tuple] = []
        # Admin verbs run on HTTP handler threads concurrently with the
        # tick thread's advance(); unlike the v1 data plane (per-shard RW
        # locks), the plane's own state (tenants/migrations/pins) is one
        # shared structure — serialize it. Reentrant: verbs call helpers
        # that re-enter (e.g. drain -> start_migration).
        self._mutex = threading.RLock()

    # -- plumbing ---------------------------------------------------------
    def _now(self) -> float:
        return self.router.backends[0].platform.clock.now()

    @_serialized
    def attach_ratelimiter(self, ratelimiter):
        """Wire the HTTP tier's rate limiter so tenant PATCHes apply live.
        Replays every stored per-tenant override into it."""
        self.ratelimiter = ratelimiter
        if ratelimiter is None:
            return
        for spec in self.tenants.values():
            if spec.rate is not None:
                ratelimiter.set_tenant_config(
                    spec.name, RateLimitConfig(rate=spec.rate,
                                               burst=spec.burst))

    def _apply_rate(self, spec: TenantSpec):
        if self.ratelimiter is None:
            return
        cfg = (RateLimitConfig(rate=spec.rate, burst=spec.burst)
               if spec.rate is not None else None)
        self.ratelimiter.set_tenant_config(spec.name, cfg)

    def _backend(self, shard_id: str):
        try:
            return self.router.backend(shard_id)
        except KeyError:
            raise ApiError(ErrorCode.NOT_FOUND,
                           f"no such shard: {shard_id}", shard=shard_id)

    # -- tenant resource --------------------------------------------------
    def tenant_view(self, spec: TenantSpec) -> dict:
        return {"api_version": ADMIN_API_VERSION, "name": spec.name,
                "quota_chips": spec.quota_chips, "tier": spec.tier,
                "rate": spec.rate, "burst": spec.burst,
                "shard": self.router.shard_for(spec.name).shard_id,
                "pinned": spec.name in self.router.pins,
                "migrating": self.router.migration_target(spec.name)
                is not None}

    @_serialized
    def create_tenant(self, spec: TenantSpec) -> dict:
        if not spec.name or spec.name == "*":
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"invalid tenant name {spec.name!r}")
        if spec.name in self.tenants:
            raise ApiError(ErrorCode.CONFLICT,
                           f"tenant {spec.name!r} already exists")
        self._validate_quota_rate(spec.quota_chips, spec.rate, spec.burst)
        if spec.shard is not None:
            backend = self._backend(spec.shard)
            if backend.cordoned:
                raise ApiError(ErrorCode.FAILED_PRECONDITION,
                               f"shard {spec.shard} is cordoned",
                               shard=spec.shard)
            self.router.pin(spec.name, spec.shard)
        spec.created_at = self._now()
        self.tenants[spec.name] = spec
        self._register_quota(spec)
        self._apply_rate(spec)
        return self.tenant_view(spec)

    def _validate_quota_rate(self, quota, rate, burst):
        if quota is not None and (not isinstance(quota, int)
                                  or isinstance(quota, bool) or quota < 0):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"quota_chips must be a non-negative integer, "
                           f"got {quota!r}")
        if (rate is None) != (burst is None):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "rate and burst must be set together")
        if rate is not None and (rate <= 0 or burst <= 0):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "rate and burst must be positive")

    def _register_quota(self, spec: TenantSpec):
        # Registered with EVERY shard's admission controller: quota follows
        # the tenant wherever routing (or a migration) places it.
        for backend in self.router.backends:
            if spec.quota_chips is None:
                backend.platform.admission.unregister_tenant(spec.name)
            else:
                backend.platform.admission.register_tenant(
                    spec.name, spec.quota_chips, tier=spec.tier)

    @_serialized
    def get_tenant(self, name: str) -> dict:
        spec = self.tenants.get(name)
        if spec is None:
            raise ApiError(ErrorCode.NOT_FOUND, f"no such tenant: {name}")
        return self.tenant_view(spec)

    @_serialized
    def list_tenants(self) -> dict:
        return {"api_version": ADMIN_API_VERSION,
                "items": [self.tenant_view(self.tenants[n])
                          for n in sorted(self.tenants)]}

    @_serialized
    def patch_tenant(self, name: str, patch: dict) -> dict:
        spec = self.tenants.get(name)
        if spec is None:
            raise ApiError(ErrorCode.NOT_FOUND, f"no such tenant: {name}")
        unknown = sorted(set(patch) - {"quota_chips", "tier", "rate",
                                       "burst"})
        if unknown:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"unknown tenant fields: {unknown}")
        quota = patch.get("quota_chips", spec.quota_chips)
        rate = patch.get("rate", spec.rate)
        burst = patch.get("burst", spec.burst)
        self._validate_quota_rate(quota, rate, burst)
        spec.quota_chips = quota
        spec.tier = patch.get("tier", spec.tier)
        spec.rate, spec.burst = rate, burst
        self._register_quota(spec)
        self._apply_rate(spec)
        return self.tenant_view(spec)

    @_serialized
    def delete_tenant(self, name: str) -> dict:
        spec = self.tenants.get(name)
        if spec is None:
            raise ApiError(ErrorCode.NOT_FOUND, f"no such tenant: {name}")
        if self.router.migration_target(name) is not None:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"tenant {name!r} is migrating")
        backend = self.router.shard_for(name)
        if not backend.alive:
            # cannot verify the tenant is idle: never guess-delete
            raise ApiError(ErrorCode.UNAVAILABLE,
                           f"shard {backend.shard_id} is down; cannot "
                           f"verify tenant {name!r} has no active jobs",
                           shard=backend.shard_id, shard_down=True)
        with backend.read_locked():
            records = backend.platform.meta.jobs(tenant=name)
            active = [r.job_id for r in records
                      if r.status not in TERMINAL
                      and r.status != JobStatus.HALTED]
        if active:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"tenant {name!r} still has active jobs",
                           jobs=active)
        del self.tenants[name]
        spec.quota_chips = None
        self._register_quota(spec)   # unregister everywhere
        spec.rate = None
        self._apply_rate(spec)       # back to the default bucket
        if not records:
            # only drop the pin when no history remains: unpinning a
            # tenant whose terminal records live on the pinned shard would
            # re-route its reads to the hash shard and strand the history
            self.router.unpin(name)
        return {"api_version": ADMIN_API_VERSION, "name": name,
                "deleted": True}

    # -- shard resource ---------------------------------------------------
    def shard_view(self, backend) -> dict:
        view = {"api_version": ADMIN_API_VERSION,
                "shard_id": backend.shard_id,
                "status": "ok" if backend.alive else "down",
                "cordoned": backend.cordoned,
                "version": getattr(backend, "version", "v0"),
                "retired": getattr(backend, "retired", False),
                "breaker": (backend.breaker.state
                            if getattr(backend, "breaker", None) is not None
                            else "closed"),
                "tenants": [], "jobs": 0, "active_jobs": 0,
                "chips_total": 0, "chips_used": 0, "queue_depth": 0}
        if not backend.alive:
            return view
        with backend.read_locked():
            p = backend.platform
            meta = p.meta
            resident = {t for t, ids in meta._by_tenant.items() if ids}
            # snapshot: shard_for's cordon-reroute may insert a pin from a
            # v1 request thread while we iterate (dict(...) is atomic)
            resident |= {t for t, sid in dict(self.router.pins).items()
                         if sid == backend.shard_id}
            active = 0
            for st, ids in meta._by_status.items():
                if st not in TERMINAL and st != JobStatus.HALTED:
                    active += len(ids)
            view.update({
                "tenants": sorted(resident),
                "jobs": len(meta._order),
                "active_jobs": active,
                "chips_total": p.cluster.total_chips,
                "chips_used": p.cluster.used_chips,
                "queue_depth": p.scheduler.queue_depth(),
            })
        return view

    @_serialized
    def list_shards(self) -> dict:
        return {"api_version": ADMIN_API_VERSION,
                "items": [self.shard_view(b) for b in self.router.backends]}

    @_serialized
    def get_shard(self, shard_id: str) -> dict:
        return self.shard_view(self._backend(shard_id))

    @_serialized
    def cordon(self, shard_id: str) -> dict:
        self._backend(shard_id).cordon()
        return self.get_shard(shard_id)

    @_serialized
    def uncordon(self, shard_id: str) -> dict:
        self._backend(shard_id).uncordon()
        return self.get_shard(shard_id)

    # -- operator resource (repro_torch.obs.operator) ---------------------------
    def _operator(self):
        if self.operator is None:
            raise ApiError(ErrorCode.NOT_FOUND,
                           "no operator installed on this deployment")
        return self.operator

    @_serialized
    def operator_status(self) -> dict:
        """Status + decision log of the autonomous operator."""
        return self._operator().status_view()

    @_serialized
    def start_rollout(self, version: str) -> dict:
        """Request a GUARD-style rolling upgrade to ``version``; waves
        start on the next federation tick."""
        return self._operator().request_rollout(version)

    # -- fault resource (repro_torch.core.faults) --------------------------------
    def _fault_plane(self):
        if self.faults is None:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           "no fault plane attached to this deployment")
        return self.faults

    @_serialized
    def install_fault(self, body: dict) -> dict:
        """Install a fault plan on a named interposition point. ``body``
        carries ``point`` plus any of ``key``/``latency_s``/``error``/
        ``hang``/``mode``/``probability`` (see ``repro_torch.core.faults``)."""
        plane = self._fault_plane()
        if not isinstance(body, dict) or "point" not in body:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must carry a fault 'point'")
        unknown = sorted(set(body) - {"point", "key", "latency_s", "error",
                                      "hang", "mode", "probability"})
        if unknown:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"unknown fault fields: {unknown}")
        try:
            plan = plane.install(
                body["point"], key=body.get("key"),
                latency_s=body.get("latency_s", 0.0),
                error=body.get("error"),
                hang=bool(body.get("hang", False)),
                mode=body.get("mode", "persistent"),
                probability=body.get("probability", 1.0))
        except (ValueError, TypeError) as e:
            raise ApiError(ErrorCode.INVALID_ARGUMENT, str(e))
        return {"api_version": ADMIN_API_VERSION, **plan}

    @_serialized
    def list_faults(self) -> dict:
        plane = self._fault_plane()
        return {"api_version": ADMIN_API_VERSION, "items": plane.list(),
                "triggered": dict(plane.triggered)}

    @_serialized
    def clear_faults(self, fault_id: Optional[str] = None) -> dict:
        """Clear one plan (waking any hung waiter on it) or, with no id,
        every installed plan."""
        plane = self._fault_plane()
        cleared = plane.clear(fault_id)
        if fault_id is not None and cleared == 0:
            raise ApiError(ErrorCode.NOT_FOUND,
                           f"no such fault: {fault_id}", fault_id=fault_id)
        return {"api_version": ADMIN_API_VERSION, "cleared": cleared}

    # -- migration resource -----------------------------------------------
    def migration_view(self, m: Migration) -> dict:
        return {"api_version": ADMIN_API_VERSION,
                "migration_id": m.migration_id, "tenant": m.tenant,
                "from_shard": m.from_shard, "to_shard": m.to_shard,
                "phase": m.phase.value, "error": m.error,
                "created_at": m.created_at, "updated_at": m.updated_at,
                "stats": dict(m.stats)}

    @_serialized
    def start_migration(self, tenant: str, to_shard: str) -> dict:
        if not tenant or not isinstance(tenant, str):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"invalid tenant {tenant!r}")
        dst = self._backend(to_shard)
        src = self.router.shard_for(tenant)
        if src is dst:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"tenant {tenant!r} is already on {to_shard}",
                           tenant=tenant, shard=to_shard)
        if dst.cordoned:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"shard {to_shard} is cordoned", shard=to_shard)
        for backend in (src, dst):
            if not backend.alive:
                raise ApiError(ErrorCode.UNAVAILABLE,
                               f"shard {backend.shard_id} is down",
                               shard=backend.shard_id, shard_down=True)
        self.router.lock_tenant(tenant, src.shard_id, dst.shard_id)  # CONFLICT
        m = Migration(migration_id=f"mig-{next(self._mig_ctr):04d}",
                      tenant=tenant, from_shard=src.shard_id,
                      to_shard=dst.shard_id, created_at=self._now(),
                      updated_at=self._now())
        self.migrations[m.migration_id] = m
        self._emit_phase(m)
        return self.migration_view(m)

    def _emit_phase(self, m: Migration):
        """migration_phase platform event into the SOURCE shard's bus,
        stamped with the migrating tenant (so the tenant can watch its own
        migration on /v2/events). Best-effort: observability must never
        fail a phase step."""
        try:
            src = self.router.backend(m.from_shard)
            src.platform.events.emit(
                "admin", "migration_phase", tenant=m.tenant,
                migration=m.migration_id, phase=m.phase.value,
                to_shard=m.to_shard)
        except Exception:
            pass

    @_serialized
    def get_migration(self, migration_id: str) -> dict:
        m = self.migrations.get(migration_id)
        if m is None:
            raise ApiError(ErrorCode.NOT_FOUND,
                           f"no such migration: {migration_id}")
        return self.migration_view(m)

    @_serialized
    def list_migrations(self) -> dict:
        return {"api_version": ADMIN_API_VERSION,
                "items": [self.migration_view(self.migrations[k])
                          for k in sorted(self.migrations)]}

    @_serialized
    def drain(self, shard_id: str) -> dict:
        """Migrate every resident tenant off ``shard_id``, then cordon it.
        Tenants with records get a migration; pinned-but-empty tenants are
        simply re-pinned. Targets are the least-occupied alive, uncordoned
        other shards."""
        backend = self._backend(shard_id)
        if not backend.alive:
            raise ApiError(ErrorCode.UNAVAILABLE,
                           f"shard {shard_id} is down", shard=shard_id,
                           shard_down=True)
        others = [b for b in self.router.backends
                  if b is not backend and b.alive and not b.cordoned]
        if not others:
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           "no alive, uncordoned shard to drain into",
                           shard=shard_id)
        backend.cordon()  # no new tenants land here while we move the rest
        # abort in-flight migrations INTO this shard: letting one complete
        # would land its tenant on the just-drained shard after the drain
        # reported success (the drain -> decommission flow would lose it)
        for m in list(self.migrations.values()):
            if m.phase in LIVE_PHASES and m.to_shard == shard_id:
                self._abort(m, f"destination {shard_id} drained")
        with backend.read_locked():
            sizes = {t: len(ids) for t, ids in
                     backend.platform.meta._by_tenant.items() if ids}
        with_jobs = sorted(sizes)
        pinned_empty = sorted(t for t, sid in dict(self.router.pins).items()
                              if sid == shard_id and t not in sizes)

        # Targets by occupancy INCLUDING the jobs this drain is about to
        # send each way — occupancy on disk doesn't change until the
        # migrations complete, so without the pending weight every tenant
        # would pile onto the single currently-least-occupied shard.
        pending: Counter = Counter()

        def least_loaded():
            return min(others,
                       key=lambda b: (len(b.platform.meta._order)
                                      + pending[b.shard_id], b.shard_id))

        migrations, repinned = [], []
        for tenant in with_jobs:
            if self.router.migration_target(tenant) is not None:
                continue  # already moving
            target = least_loaded()
            view = self.start_migration(tenant, target.shard_id)
            pending[target.shard_id] += sizes[tenant]
            migrations.append(view["migration_id"])
        for tenant in pinned_empty:
            target = least_loaded()
            pending[target.shard_id] += 1
            self.router._force_pin(tenant, target.shard_id)
            if tenant in self.tenants:
                self.tenants[tenant].shard = target.shard_id
            repinned.append(tenant)
        return {"api_version": ADMIN_API_VERSION, "shard_id": shard_id,
                "cordoned": True, "migrations": migrations,
                "repinned": repinned}

    # -- the migration state machine --------------------------------------
    @_serialized
    def advance(self):
        """One phase step per live migration; called from Federation.tick.
        Also retries resumes/purges deferred on a dead shard."""
        self._run_deferred()
        for m in list(self.migrations.values()):
            if m.phase not in LIVE_PHASES:
                continue
            src = self.router.backend(m.from_shard)
            dst = self.router.backend(m.to_shard)
            if not src.alive or not dst.alive:
                down = src if not src.alive else dst
                self._abort(m, f"shard {down.shard_id} went down during "
                               f"{m.phase.value}")
                continue
            try:
                if m.phase == MigrationPhase.SNAPSHOT:
                    self._copy_delta(m, src, dst)
                    m.phase = MigrationPhase.CATCHUP
                elif m.phase == MigrationPhase.CATCHUP:
                    with src.write_locked():
                        m.halted_jobs += self._quiesce(src.platform,
                                                       m.tenant)
                    self._copy_delta(m, src, dst)
                    m.stats["catchup_rounds"] += 1
                    m.phase = MigrationPhase.CUTOVER
                elif m.phase == MigrationPhase.CUTOVER:
                    self._cutover(m, src, dst)
                    m.phase = MigrationPhase.DONE
                self._emit_phase(m)
            except (ConnectionError, ObjectStoreError) as e:
                # a metastore or object store failed mid-step: abort back
                # to the intact source of truth
                self._abort(m, f"storage failure during "
                               f"{m.phase.value}: {e}")
                continue
            m.updated_at = self._now()

    def _copy_delta(self, m: Migration, src, dst):
        """Export everything past the watermarks from the source, import
        into the destination. First call = the bulk SNAPSHOT (watermark 0,
        jobs still running); later calls = CATCHUP/CUTOVER deltas."""
        with src.read_locked():
            snap = src.platform.meta.export_tenant(m.tenant,
                                                   since=m.wal_watermark)
            logs = {}
            for jid in snap["records"]:
                since = m.log_watermarks.get(jid, 0)
                recs = src.platform.log_index.export_job(jid, since=since)
                if recs:
                    logs[jid] = (since, recs)
        with dst.write_locked():
            dst.platform.meta.import_tenant(snap)
            for jid, (since, recs) in logs.items():
                dst.platform.log_index.import_records(recs)
        m.wal_watermark = snap["watermark"]
        for jid, (since, recs) in logs.items():
            m.log_watermarks[jid] = since + len(recs)
        m.stats["ops_copied"] += len(snap["ops"])
        m.stats["records_copied"] += len(snap["records"])
        m.stats["log_lines_copied"] += sum(len(r) for _, r in logs.values())

    @staticmethod
    def _quiesce(platform, tenant: str) -> list:
        """Checkpoint-and-halt every non-terminal job of ``tenant`` NOW
        (the platform's own preemption teardown, forced synchronously so
        the cutover never waits on a job stuck in a deploy stage). Returns
        the job ids halted — they are resumed on the destination after
        cutover, or back on the source if the migration aborts. Caller
        holds the source's write lock."""
        halted = []
        for rec in platform.meta.jobs(tenant=tenant):
            if rec.status in TERMINAL or rec.status == JobStatus.HALTED:
                continue
            guardian = platform.guardians.get(rec.job_id)
            if guardian is not None and guardian.stage != "GC_DONE":
                guardian._do_halt()  # teardown + checkpointed state kept
            else:
                platform.meta.update_status(rec.job_id, JobStatus.HALTED,
                                            "halted")
            platform.guardians.pop(rec.job_id, None)
            halted.append(rec.job_id)
        return halted

    def _cutover(self, m: Migration, src, dst):
        """The atomic flip: both write locks (in shard order, the same
        total order AllShardsLock uses), final delta, runtime-state move,
        source purge, pin flip, destination resume. In-flight v1 requests
        either ran before the locks (old shard, fully present) or resolve
        after them (new shard, fully present)."""
        first, second = sorted(
            (src, dst), key=lambda b: self.router.backends.index(b))
        with first.write_locked(), second.write_locked():
            # submits that landed after the CATCHUP quiesce
            m.halted_jobs += self._quiesce(src.platform, m.tenant)
            snap = src.platform.meta.export_tenant(m.tenant,
                                                   since=m.wal_watermark)
            dst.platform.meta.import_tenant(snap)
            m.stats["ops_copied"] += len(snap["ops"])
            m.stats["records_copied"] += len(snap["records"])
            job_ids = sorted(src.platform.meta._by_tenant.get(m.tenant, []))
            # copy phase first — it can FAIL (object-store fault) and must
            # leave the source fully intact so the abort path stays clean;
            # only after every copy lands do the destructive steps run
            for jid in job_ids:
                since = m.log_watermarks.get(jid, 0)
                recs = src.platform.log_index.export_job(jid, since=since)
                if recs:
                    dst.platform.log_index.import_records(recs)
                    m.stats["log_lines_copied"] += len(recs)
                self._copy_runtime_state(m, src.platform, dst.platform, jid)
            for jid in job_ids:
                self._drop_runtime_state(src.platform, dst.platform, jid)
            src.platform.log_index.purge_jobs(job_ids)
            src.platform.meta.purge_tenant(m.tenant)
            self.router._force_pin(m.tenant, m.to_shard)
            self.router.unlock_tenant(m.tenant)
            if m.tenant in self.tenants:
                self.tenants[m.tenant].shard = m.to_shard
            self._resume_jobs(dst, m.halted_jobs, "resumed after migration")

    def _copy_runtime_state(self, m: Migration, src_p, dst_p, job_id: str):
        """Volume (checkpoints, log offsets, creds) and object-store
        artifacts follow the job. NON-destructive: the source keeps
        everything, so an object-store fault here propagates and aborts
        the cutover with the source still whole — never a silent loss of
        a migrated job's results."""
        vol = src_p.volumes.get(job_id)
        if vol is not None:
            dst_p.volumes[job_id] = vol
            m.stats["volumes_moved"] += 1
        rec = dst_p.meta.get(job_id)
        if rec is None:
            return
        bucket = rec.manifest.results_bucket
        for key in src_p.objstore.list(bucket, prefix=f"{job_id}/"):
            # get/put raise ObjectStoreError on a fault -> cutover aborts
            dst_p.objstore.put(bucket, key, src_p.objstore.get(bucket, key))
            m.stats["objects_copied"] += 1

    @staticmethod
    def _drop_runtime_state(src_p, dst_p, job_id: str):
        """Destructive source cleanup, run only after EVERY copy landed.
        Nothing here can fail (dict pops + ObjectStore.delete never
        raises); leftovers would be garbage, not data loss."""
        src_p.volumes.pop(job_id, None)
        if job_id in src_p.admission.over_quota:
            dst_p.admission.over_quota[job_id] = \
                src_p.admission.over_quota.pop(job_id)
        rec = dst_p.meta.get(job_id)
        if rec is not None:
            bucket = rec.manifest.results_bucket
            for key in dst_p.objstore.list(bucket, prefix=f"{job_id}/"):
                src_p.objstore.delete(bucket, key)

    def _abort(self, m: Migration, error: str):
        """Back to a consistent source of truth: unlock routing, resume
        whatever the quiesce halted on the SOURCE (now, or when a dead
        source comes back up — a migration-quiesced job must never be
        left HALTED forever), and purge the partial import from the
        destination (now, or when it comes back up)."""
        m.phase = MigrationPhase.FAILED
        m.error = error
        m.updated_at = self._now()
        self._emit_phase(m)
        self.router.unlock_tenant(m.tenant)
        if m.halted_jobs:
            # resume wherever the tenant is ROUTED now — normally the
            # source, but if the failure struck after the cutover's pin
            # flip the destination is already authoritative and the
            # records are purged from the source
            owner = self.router.shard_for(m.tenant).shard_id
            self._deferred_resumes.append((owner, list(m.halted_jobs)))
        self._deferred_purges.append((m.to_shard, m.tenant))
        self._run_deferred()

    @staticmethod
    def _resume_jobs(backend, job_ids, msg: str):
        """Caller holds the backend's write lock."""
        for jid in job_ids:
            rec = backend.platform.meta.get(jid)
            if rec is not None and rec.status == JobStatus.HALTED:
                backend.platform.guardians.pop(jid, None)
                backend.platform.meta.update_status(jid, JobStatus.RESUMED,
                                                    msg)

    def _run_deferred(self):
        """Abort cleanup that could not run while a shard was down."""
        still = []
        for shard_id, job_ids in self._deferred_resumes:
            backend = self.router.backend(shard_id)
            if not backend.alive:
                still.append((shard_id, job_ids))
                continue
            with backend.write_locked():
                try:
                    self._resume_jobs(backend, job_ids,
                                      "resumed after aborted migration")
                except ConnectionError:
                    still.append((shard_id, job_ids))
        self._deferred_resumes = still
        still = []
        for shard_id, tenant in self._deferred_purges:
            backend = self.router.backend(shard_id)
            # never purge the tenant's CURRENT shard (e.g. a later
            # migration moved it here in the meantime)
            if self.router.shard_for(tenant) is backend:
                continue
            if not backend.alive:
                still.append((shard_id, tenant))
                continue
            with backend.write_locked():
                try:
                    p = backend.platform
                    # grab result buckets BEFORE purging the manifests, so
                    # artifacts copied by an aborted cutover are removed
                    # too (not leaked on the abandoned destination)
                    buckets = {r.job_id: r.manifest.results_bucket
                               for r in p.meta.jobs(tenant=tenant)}
                    jids = p.meta.purge_tenant(tenant)
                    p.log_index.purge_jobs(jids)
                    for jid in jids:
                        p.volumes.pop(jid, None)
                        bucket = buckets.get(jid)
                        if bucket is None:
                            continue
                        for key in p.objstore.list(bucket,
                                                   prefix=f"{jid}/"):
                            p.objstore.delete(bucket, key)
                except ConnectionError:
                    still.append((shard_id, tenant))
        self._deferred_purges = still


# Every AdminGateway verb runs inside a deadline scope (the v2 analogue
# of the v1 gateway's _deadlined; enforced by the DEADLINE-VERB check).
_deadlined = deadline_guarded()


class AdminGateway:
    """The wire-facing v2 verb surface: admin auth in front of the shared
    :class:`AdminPlane`. Every verb takes ``(api_key, ...)`` and returns a
    plain JSON-able dict stamped ``"api_version": "v2"`` — the HTTP layer
    serializes it verbatim, and the in-process surface is identical."""

    # per-verb deadline budget; instances may tighten it (drills do)
    verb_budget_s = 10.0

    def __init__(self, plane: AdminPlane, auth: AuthService):
        self.plane = plane
        self.auth = auth

    def _require(self, api_key: str) -> Principal:
        principal = self.auth.require(api_key, ADMIN)
        if not principal.is_admin:
            raise ApiError(ErrorCode.FORBIDDEN,
                           "admin plane requires an operator (\"*\") key")
        return principal

    # -- tenants ----------------------------------------------------------
    @_deadlined
    def create_tenant(self, api_key: str, body: dict) -> dict:
        self._require(api_key)
        if not isinstance(body, dict) or "name" not in body:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must carry a tenant 'name'")
        unknown = sorted(set(body) - {"name", "quota_chips", "tier", "rate",
                                      "burst", "shard"})
        if unknown:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           f"unknown tenant fields: {unknown}")
        return self.plane.create_tenant(TenantSpec(
            name=body["name"], quota_chips=body.get("quota_chips"),
            tier=body.get("tier", "paid"), rate=body.get("rate"),
            burst=body.get("burst"), shard=body.get("shard")))

    @_deadlined
    def get_tenant(self, api_key: str, name: str) -> dict:
        self._require(api_key)
        return self.plane.get_tenant(name)

    @_deadlined
    def list_tenants(self, api_key: str) -> dict:
        self._require(api_key)
        return self.plane.list_tenants()

    @_deadlined
    def patch_tenant(self, api_key: str, name: str, patch: dict) -> dict:
        self._require(api_key)
        if not isinstance(patch, dict):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "patch must be a JSON object")
        return self.plane.patch_tenant(name, patch)

    @_deadlined
    def delete_tenant(self, api_key: str, name: str) -> dict:
        self._require(api_key)
        return self.plane.delete_tenant(name)

    # -- shards -----------------------------------------------------------
    @_deadlined
    def list_shards(self, api_key: str) -> dict:
        self._require(api_key)
        return self.plane.list_shards()

    @_deadlined
    def get_shard(self, api_key: str, shard_id: str) -> dict:
        self._require(api_key)
        return self.plane.get_shard(shard_id)

    @_deadlined
    def cordon_shard(self, api_key: str, shard_id: str) -> dict:
        self._require(api_key)
        return self.plane.cordon(shard_id)

    @_deadlined
    def uncordon_shard(self, api_key: str, shard_id: str) -> dict:
        self._require(api_key)
        return self.plane.uncordon(shard_id)

    @_deadlined
    def drain_shard(self, api_key: str, shard_id: str) -> dict:
        self._require(api_key)
        return self.plane.drain(shard_id)

    # -- operator ---------------------------------------------------------
    @_deadlined
    def operator_status(self, api_key: str) -> dict:
        self._require(api_key)
        return self.plane.operator_status()

    @_deadlined
    def start_rollout(self, api_key: str, body: dict) -> dict:
        self._require(api_key)
        if not isinstance(body, dict) or not isinstance(
                body.get("version"), str) or not body["version"]:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must carry a non-empty 'version' string")
        return self.plane.start_rollout(body["version"])

    # -- faults -----------------------------------------------------------
    @_deadlined
    def install_fault(self, api_key: str, body: dict) -> dict:
        self._require(api_key)
        if not isinstance(body, dict):
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must be a JSON object")
        return self.plane.install_fault(body)

    @_deadlined
    def list_faults(self, api_key: str) -> dict:
        self._require(api_key)
        return self.plane.list_faults()

    @_deadlined
    def clear_faults(self, api_key: str,
                     fault_id: Optional[str] = None) -> dict:
        self._require(api_key)
        return self.plane.clear_faults(fault_id)

    # -- migrations -------------------------------------------------------
    @_deadlined
    def start_migration(self, api_key: str, body: dict) -> dict:
        self._require(api_key)
        if not isinstance(body, dict) or "tenant" not in body \
                or "to_shard" not in body:
            raise ApiError(ErrorCode.INVALID_ARGUMENT,
                           "body must carry 'tenant' and 'to_shard'")
        return self.plane.start_migration(body["tenant"], body["to_shard"])

    @_deadlined
    def get_migration(self, api_key: str, migration_id: str) -> dict:
        self._require(api_key)
        return self.plane.get_migration(migration_id)

    @_deadlined
    def list_migrations(self, api_key: str) -> dict:
        self._require(api_key)
        return self.plane.list_migrations()
