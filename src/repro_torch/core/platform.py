"""FfDLPlatform: the facade wiring all microservices together (FfDL Fig 1-2),
the port's copy of the reference's (``repro/core/platform.py``): the same
services, ticked in the same order, so one scenario from one seed gives the
same status histories, events, placements and metastore records on both.

The public API surface lives in :mod:`repro_torch.api` (FfDL §3.2): a tier of
**stateless, replicated** gateways (``ApiGateway``) behind a round-robin
``LoadBalancer``, speaking the versioned v1 contract — typed
request/response envelopes, per-tenant API-key auth with scope checks,
structured ``ApiError`` codes, client-supplied idempotency keys on
``submit`` (deduplicated durably via the metastore WAL), and
cursor-paginated listings. Crash any single replica and idempotent calls
still succeed (``benchmarks/api_tier.py`` measures this recovery claim).

This class is the **control plane**: it owns and ticks every microservice:
chaos → cluster (heartbeats/evictions) → LCM (reconcile) → guardians
(deploy/monitor) → admission (preemption) → scheduler (gang placement) →
metrics. Internal lifecycle actions (``_halt_internal``/
``_resume_internal``, used by admission preemption and requeue timers)
bypass the API tier: they must keep working while every gateway replica
is down.

All *user-facing* operations go through the API tier with a tenant-scoped
key — in-process via ``platform.api`` (the balancer), ergonomically via
``ApiClient.for_platform(platform, tenant)``, or over the wire via
``repro.api.http``. The pre-gateway raw-exception facade
(``platform.submit()`` & friends, which translated ``ApiError`` back to
``ValueError``/``KeyError``/...) is retired: every caller sees the stable
``ApiError`` codes now.

API-layer semantics reproduced (all via the gateway):
  * ``submit`` validates, persists to the metastore **before acking** and
    returns a job id — jobs survive any subsequent component crash;
  * ``status``/``status_history`` read the metastore (user-visible,
    timestamped — the paper's billing/debugging requirement);
  * ``logs``/``search_logs`` read the ElasticSearch-like index;
  * ``halt``/``resume`` drive HALT/RESUME for hyperparameter workflows;
  * API replicas are stateless: ``api_crash``/``api_restart`` only gate the
    public methods (recovery-time benchmark).

``tick()`` is one platform scheduling round; ``run_until`` drives the
simulated clock.

Where the port differs:
  * ``device`` names where real jobs train: the guardian hands it to each
    learner through ``LearnerContext``, and ``make_learner`` builds a
    ``TorchLearner`` on it for a manifest with an arch. ``None`` is the
    card, as at every entry point of the port; the tests pass ``"cpu"``.
    Without a card a real job on the default device ends FAILED, its
    learner's ``fatal:`` log naming the missing card: it never trains on
    the CPU. Simulated jobs (``SimLearner``) touch no device.
"""

from __future__ import annotations

import itertools
from typing import Optional

from repro_torch.api.auth import AuthService
from repro_torch.api.backend import Backend
from repro_torch.api.gateway import ApiGateway
from repro_torch.api.lb import LoadBalancer
from repro_torch.api.router import TenantRouter
from repro_torch.core.admission import AdmissionController
from repro_torch.core.chaos import ChaosConfig, ChaosMonkey
from repro_torch.core.cluster import ClusterModel
from repro_torch.core.executor import JobVolume
from repro_torch.core.helpers import LogIndex, MetricsService
from repro_torch.core.kvstore import EtcdLike
from repro_torch.core.lcm import LifecycleManager
from repro_torch.core.metastore import MetaStore
from repro_torch.core.scheduler import GangScheduler, K8sDefaultScheduler
from repro_torch.core.types import (
    EventLog,
    JobStatus,
    SimClock,
    TERMINAL,
    gang_chips,
)
from repro_torch.data.objectstore import ObjectStore
from repro_torch.obs import DEFAULT_RETENTION, UsageMeter, install_meter


class FfDLPlatform:
    def __init__(self, n_hosts: int = 16, chips_per_host: int = 4,
                 placement: str = "pack", scheduler: str = "gang",
                 chaos: Optional[ChaosConfig] = None, clock=None,
                 tick_period: float = 1.0, seed: int = 0,
                 objstore_bandwidth: Optional[float] = None,
                 n_api_replicas: int = 3, shard_id: str = "shard-0",
                 job_id_base: int = 0, shared_reads: bool = True,
                 event_retention: int = DEFAULT_RETENTION,
                 fault_plane=None, device=None):
        # -- shard construction hooks (repro.api.federation) --------------
        # shard_id names this platform as a backend shard; job_id_base
        # offsets the job counter so ids stay globally unique across a
        # federation; shared_reads=False degrades the shard lock to the
        # pre-federation exclusive behaviour (benchmark baseline).
        self.shard_id = shard_id
        self.job_id_base = job_id_base
        self.device = device  # where real jobs train: None is the card
        self.clock = clock or SimClock()
        self.tick_period = tick_period
        self.ticks = 0  # scheduling rounds since construction (uptime)
        self.events = EventLog(self.clock, retention=event_retention,
                               shard_id=shard_id)
        self.etcd = EtcdLike(self.clock, self.events)
        # Unified fault-injection plane (repro_torch.core.faults): every gray-
        # failure interposition point on this shard draws from this one
        # seeded registry. A Federation passes its shared plane in so one
        # /v2/admin/faults surface covers the whole fleet; standalone
        # platforms get their own.
        from repro_torch.core.faults import FaultPlane
        self.faults = fault_plane if fault_plane is not None \
            else FaultPlane(seed=seed)
        self.meta = MetaStore(self.clock)
        self.meta.faults = self.faults
        self.meta.fault_key = shard_id
        self.objstore = ObjectStore(clock=None,
                                    bandwidth_bps=objstore_bandwidth)
        self.objstore.faults = self.faults
        self.objstore.fault_key = shard_id
        self.objstore.create_bucket("datasets")
        self.objstore.create_bucket("results")
        self.cluster = ClusterModel(n_hosts, chips_per_host, self.clock,
                                    self.etcd, self.events)
        if scheduler == "gang":
            self.scheduler = GangScheduler(self.cluster, self.events,
                                           placement=placement, seed=seed)
        else:
            self.scheduler = K8sDefaultScheduler(self.cluster, self.events,
                                                 placement=placement,
                                                 seed=seed)
        self.admission = AdmissionController(self, self.events)
        self.lcm = LifecycleManager(self, self.events)
        self.chaos = ChaosMonkey(chaos or ChaosConfig(), self)
        self.metrics = MetricsService(self.clock)
        self.log_index = LogIndex()
        # -- observability plane (repro_torch.obs): the bus stamps events with
        # their owning tenant (so /v2/events can scope visibility) and the
        # meter accrues per-tenant usage — job outcomes + 429s via a bus
        # tap, log bytes via the index append hook, chip-seconds in tick().
        self.meter = UsageMeter()
        self.events.tenant_resolver = self._tenant_of_job
        install_meter(self.events, self.meter)
        self.log_index.on_append = self._meter_log_bytes
        self.guardians: dict[str, object] = {}
        self.volumes: dict[str, JobVolume] = {}
        self._job_ctr = itertools.count(job_id_base + 1)
        # ------------------------------------------------ API tier (§3.2)
        # A standalone platform is a one-shard federation: the gateway
        # replicas route through a TenantRouter over this platform's own
        # Backend (per-shard RW lock + health). repro.api.federation
        # reuses the same Backend when composing multi-shard tiers, so
        # there is exactly one lock per shard no matter who fronts it.
        self.auth = AuthService(seed=seed)
        self.backend = Backend(shard_id, self, shared_reads=shared_reads)
        self.router = TenantRouter([self.backend])
        self.api_replicas = [
            ApiGateway(self.router, self.auth, replica_id=f"api-{i}",
                       events=self.events)
            for i in range(max(1, n_api_replicas))]
        self.api = LoadBalancer(self.api_replicas, events=self.events)
        # v2 admin control plane (repro_torch.api.admin): on a standalone
        # platform it manages tenants/quotas/rate limits and exposes the
        # single shard as a resource; migrations need a Federation.
        from repro_torch.api.admin import AdminGateway, AdminPlane
        self.admin = AdminPlane(self.router, self.auth)
        self.admin.faults = self.faults
        self.admin_api = AdminGateway(self.admin, self.auth)
        # v2 workloads plane (repro_torch.workloads): manifests are storable and
        # wire-addressable on a standalone platform, but convergence is a
        # Federation concern — Federation.tick steps the reconciler, like
        # migrations only advance under a Federation.
        from repro_torch.workloads import WorkloadGateway, WorkloadPlane
        self.workloads = WorkloadPlane(self.router, self.auth)
        self.workloads_api = WorkloadGateway(self.workloads, self.auth)

    # ------------------------------------------------- API tier lifecycle
    @property
    def _api_up(self) -> bool:
        return any(r.alive for r in self.api_replicas)

    def api_crash(self, replica: Optional[int] = None):
        """Crash one replica (by index) or, by default, the whole tier."""
        targets = (self.api_replicas if replica is None
                   else [self.api_replicas[replica]])
        for r in targets:
            r.alive = False  # silent: a dead replica emits nothing

    def api_restart(self, replica: Optional[int] = None):
        targets = (self.api_replicas if replica is None
                   else [self.api_replicas[replica]])
        for r in targets:
            if not r.alive:
                r.restart()

    # --------------------------------------------- internal control plane
    # These bypass the API tier: admission preemption and requeue timers
    # must keep working while every gateway replica is crashed.
    def _next_job_id(self) -> str:
        return f"job-{next(self._job_ctr):05d}"

    def _halt_internal(self, job_id: str, requeue: bool = False):
        g = self.guardians.get(job_id)
        if g is not None:
            g.halt()
        else:
            self.meta.update_status(job_id, JobStatus.HALTED, "halted")
        if requeue:
            # preempted jobs go back through the queue automatically
            def do_resume(job_id=job_id):
                rec = self.meta.get(job_id)
                if rec is not None and rec.status == JobStatus.HALTED:
                    self._resume_internal(job_id)
            self.clock.call_later(3 * self.tick_period, do_resume)

    def _resume_internal(self, job_id: str):
        self.guardians.pop(job_id, None)
        self.meta.update_status(job_id, JobStatus.RESUMED, "user resume")

    def _cancel_internal(self, job_id: str):
        g = self.guardians.get(job_id)
        if g is not None:
            g._fail("user cancelled")

    # ---------------------------------------------- observability helpers
    def _tenant_of_job(self, job_id: str) -> Optional[str]:
        """Bus tenant resolver: who owns this job? None while the
        metastore is unreachable — the event stays unstamped (admin-only
        visibility) rather than blocking the emitter."""
        try:
            rec = self.meta.get(job_id)
        except Exception:
            return None
        return rec.manifest.tenant if rec is not None else None

    def _meter_log_bytes(self, rec):
        tenant = self._tenant_of_job(rec.job_id)
        if tenant is not None:
            self.meter.bump(tenant, "log_bytes", len(rec.line))

    # chip-holding statuses: the gang's chips are reserved on hosts
    _BILLABLE = frozenset({JobStatus.DEPLOYING, JobStatus.DOWNLOADING,
                           JobStatus.PROCESSING, JobStatus.STORING})

    def _accrue_chip_seconds(self):
        """One tick of per-tenant chip-second accrual — the federation
        aggregates usage at exactly this cadence (FfDL §4 billing)."""
        for job_id in list(self.guardians):
            try:
                rec = self.meta.get(job_id)
            except Exception:
                break  # metastore down this round: bill nothing, not junk
            if rec is None or rec.status not in self._BILLABLE:
                continue
            self.meter.bump(rec.manifest.tenant, "chip_seconds",
                            gang_chips(rec.manifest) * self.tick_period)

    # ------------------------------------------------------------- engine
    def tick(self):
        # shard.tick interposition: an injected hang here wedges the shard
        # exactly like a gray failure would — the tick thread holds the
        # shard write lock, verbs bound their lock waits by deadline, and
        # Federation.tick's per-shard tick budget frees the ticker itself.
        self.faults.on("shard.tick", key=self.shard_id)
        self.ticks += 1
        self.clock.advance(self.tick_period)
        self.clock.run_until(self.clock.now())
        # Group-commit scope: every metastore status flip this round rides
        # one WAL write+flush at scope exit (durable before tick returns)
        # instead of one flush per update. User-facing submits come in via
        # the gateway outside this scope and keep durable-before-ack.
        with self.meta.batch():
            self.chaos.tick()
            self.cluster.tick()
            self.lcm.tick()
            for g in list(self.guardians.values()):
                g.tick()
            self.admission.tick()
            self.scheduler.tick()
        self.metrics.sample_utilization(self.cluster.utilization())
        self._accrue_chip_seconds()
        # GC finished guardians
        for job_id, g in list(self.guardians.items()):
            if g.stage == "GC_DONE":
                rec = self.meta.get(job_id)
                if rec.status in TERMINAL or rec.status == JobStatus.HALTED:
                    del self.guardians[job_id]

    def run_for(self, sim_seconds: float):
        n = int(sim_seconds / self.tick_period)
        for _ in range(n):
            self.tick()

    def run_until_terminal(self, job_ids, max_sim_s: float = 1e5) -> bool:
        """Tick until all jobs are COMPLETED/FAILED/HALTED. True if so."""
        deadline = self.clock.now() + max_sim_s
        watch = set(job_ids)
        while self.clock.now() < deadline:
            self.tick()
            done = all(
                self.meta.get(j) is not None and
                (self.meta.get(j).status in TERMINAL or
                 self.meta.get(j).status == JobStatus.HALTED)
                for j in watch)
            if done:
                return True
        return False
