"""Federation: N independent FfDLPlatform shards behind one gateway tier.

FfDL §3 scales the backend microservices *independently* of the REST tier:
the metastore is sharded, and the stateless API layer in front of it never
changes its wire contract when the backend is re-architected. This module
is that composition for our reproduction:

  * **N shards** — each an ordinary :class:`FfDLPlatform` (own metastore
    WAL, scheduler, cluster, log index, sim clock), constructed with the
    shard hooks (``shard_id``, ``job_id_base``) so job ids are globally
    unique (shard *i* mints ``job-{i*10^6 + n}``);
  * **one auth domain** — a single shared :class:`AuthService`; a tenant's
    key works at any gateway replica regardless of which shard holds the
    tenant's jobs;
  * **one gateway tier** — replicated :class:`ApiGateway` instances over a
    :class:`TenantRouter` (hash-by-tenant + pin table), fronted by the
    same round-robin :class:`LoadBalancer`. Replica crashes are masked
    exactly as on a single platform; a *shard* crash surfaces as
    ``UNAVAILABLE`` for that shard's tenants only.

``tick()`` advances every live shard under its own write lock — while
shard 0 is mid-tick, reads for tenants on shards 1..N-1 proceed. This
per-shard ticking is what the ``benchmarks/api_tier.py`` federation drill
measures against the old global-lock baseline.

A ``Federation`` quacks like a platform to the HTTP layer: it exposes
``api``, ``auth``, ``api_replicas``, and ``router``, so
``ApiHttpServer(Federation(...))`` serves the identical v1 wire contract.

The **v2 admin control plane** (``repro_torch.api.admin``) rides on top:
``federation.admin`` is the shared :class:`AdminPlane` (tenants, shards,
migrations as resources), ``federation.admin_api`` the admin-scoped
gateway over it, and ``tick()`` advances live tenant migrations one phase
per round after the shard ticks.

The port's copy of the reference's ``repro/api/federation.py``. Where it
differs: ``device`` names where the shards' real jobs train, and passes to
every shard the federation builds, the ones ``add_shard`` mints included.
``None`` is the card, as at every entry point of the port; the tests pass
``"cpu"``. Without a card a real job (a Pipeline stage with an ``arch``)
ends FAILED, its learner's ``fatal:`` log naming the missing card: it never
trains on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.api.admin import AdminGateway, AdminPlane
from repro_torch.api.auth import AuthService
from repro_torch.api.gateway import ApiGateway
from repro_torch.api.lb import LoadBalancer
from repro_torch.api.router import TenantRouter
from repro_torch.core.faults import DeadlineExceeded, FaultPlane, deadline_scope

# Shard i mints job ids from i*STRIDE + 1: globally unique, still matching
# the wire's ``job-\d+`` shape, and ordered within every shard.
JOB_ID_STRIDE = 1_000_000

# Per-shard tick budget (seconds, wall clock). A gray-failed shard whose
# tick hangs would otherwise wedge the federation's whole ticker thread;
# instead the tick raises DeadlineExceeded at the budget, the shard's
# breaker records the overrun, and the fleet keeps ticking.
DEFAULT_TICK_BUDGET_S = 5.0


class Federation:
    def __init__(self, n_shards: int = 2, n_api_replicas: int = 3,
                 seed: int = 0, shared_reads: bool = True,
                 pins: Optional[Dict[str, str]] = None,
                 tick_budget_s: float = DEFAULT_TICK_BUDGET_S,
                 device=None, **platform_kwargs):
        # lazy import: repro_torch.core.platform itself imports repro_torch.api.*
        from repro_torch.core.platform import FfDLPlatform
        # Construction recipe kept so the operator can mint identical
        # shards at scale-up time (add_shard).
        self._seed = seed
        self._shared_reads = shared_reads
        self._platform_kwargs = dict(platform_kwargs)
        self._next_shard_idx = max(1, n_shards)
        self.tick_budget_s = tick_budget_s
        self.device = device  # where the shards' real jobs train: None is the card
        # ONE fault plane for the whole fleet: every shard's interposition
        # points draw from this seeded registry, and one /v2/admin/faults
        # surface controls it all.
        self.faults = FaultPlane(seed=seed)
        self.shards = [
            FfDLPlatform(shard_id=f"shard-{i}",
                         job_id_base=i * JOB_ID_STRIDE,
                         shared_reads=shared_reads,
                         n_api_replicas=1,  # shards' own tiers are unused
                         seed=seed + i, fault_plane=self.faults,
                         device=device, **platform_kwargs)
            for i in range(max(1, n_shards))]
        # Reuse each platform's OWN Backend: one lock per shard, shared by
        # every front (the shard's vestigial tier and this federation).
        self.backends = [p.backend for p in self.shards]
        self.router = TenantRouter(self.backends, pins=pins)
        self.auth = AuthService(seed=seed)
        self.api_replicas = [
            ApiGateway(self.router, self.auth, replica_id=f"api-{i}")
            for i in range(max(1, n_api_replicas))]
        self.api = LoadBalancer(self.api_replicas)
        # v2 admin control plane: one shared plane, admin-scoped gateway
        self.admin = AdminPlane(self.router, self.auth)
        self.admin.faults = self.faults
        self.admin_api = AdminGateway(self.admin, self.auth)
        # autonomous operator (repro_torch.api.ops.install_operator attaches one)
        self.operator = None
        # v2 workloads plane: declarative manifests + the reconciler that
        # converges them once per tick (after admin.advance/operator.step)
        from repro_torch.workloads import (WorkloadGateway, WorkloadPlane,
                                     WorkloadReconciler)
        self.workloads = WorkloadPlane(self.router, self.auth)
        self.workloads_api = WorkloadGateway(self.workloads, self.auth)
        self.reconciler = WorkloadReconciler(self, self.workloads)

    # -- routing ----------------------------------------------------------
    def pin(self, tenant: str, shard_id: str):
        """Place a tenant on a named shard (overrides hash routing)."""
        self.router.pin(tenant, shard_id)

    def shard_of(self, tenant: str) -> str:
        return self.router.shard_for(tenant).shard_id

    # -- admin convenience (the wire surface is repro_torch.api.admin) ----------
    def migrate(self, tenant: str, to_shard: str) -> str:
        """Start a live tenant migration; returns the migration id. The
        state machine advances one phase per ``tick()``."""
        return self.admin.start_migration(tenant, to_shard)["migration_id"]

    # -- elasticity (driven by repro_torch.obs.operator) -------------------------
    def add_shard(self) -> str:
        """Mint a fresh shard with the federation's own construction recipe
        and join it to the fleet. Returns the new shard id.

        Routing safety: appending a backend changes the tenant-hash
        modulus, so BEFORE the list grows every tenant with state anywhere
        (plane spec, pin, or job records) is force-pinned to the shard it
        currently routes to — its placement cannot jump. Only tenants the
        platform has never seen re-hash over the larger fleet.
        """
        from repro_torch.core.platform import FfDLPlatform
        with self.admin._mutex:
            known = set(self.admin.tenants) | set(self.router.pins)
            for b in self.backends:
                if b.alive:
                    with b.read_locked():
                        known |= {t for t, ids in
                                  b.platform.meta._by_tenant.items() if ids}
            for tenant in sorted(known):
                self.router._force_pin(
                    tenant, self.router.shard_for(tenant).shard_id)
            i = self._next_shard_idx
            self._next_shard_idx += 1
            p = FfDLPlatform(shard_id=f"shard-{i}",
                             job_id_base=i * JOB_ID_STRIDE,
                             shared_reads=self._shared_reads,
                             n_api_replicas=1,
                             seed=self._seed + i, fault_plane=self.faults,
                             device=self.device, **self._platform_kwargs)
            self.shards.append(p)
            self.backends.append(p.backend)
            # The router holds its OWN copy of the backend list — register
            # with both, or the new shard is invisible to routing.
            self.router.backends.append(p.backend)
            self.router._by_id[p.backend.shard_id] = p.backend
            # Tenant quotas follow the tenant to ANY shard: register every
            # existing quota with the new shard's admission controller.
            for spec in self.admin.tenants.values():
                if spec.quota_chips is not None:
                    p.admission.register_tenant(
                        spec.name, spec.quota_chips, tier=spec.tier)
            return p.backend.shard_id

    def retire_shard(self, shard_id: str):
        """Fence a drained shard out of the fleet: cordoned + no longer
        ticked. It stays in the router (hash modulus, composite cursors)."""
        self.router.backend(shard_id).retire()

    # -- engine -----------------------------------------------------------
    def tick(self):
        """One round on every live shard, each under its OWN write lock —
        reads on other shards are never blocked by this shard's tick.
        Live tenant migrations advance one phase per round afterwards,
        then the autonomous operator (when installed) reconciles once,
        then the workloads reconciler converges applied manifests.

        Each shard tick runs under a wall-clock deadline budget
        (``tick_budget_s``): a shard whose tick hangs or runs long (gray
        failure) raises out of its scope instead of wedging the ticker
        thread, its breaker records the overrun (feeding the quarantine
        the gateway enforces), and the remaining shards still tick."""
        for backend in self.backends:
            if not backend.alive or backend.retired:
                continue
            try:
                with backend.write_locked(), \
                        deadline_scope(self.tick_budget_s):
                    backend.platform.tick()
            except DeadlineExceeded:
                backend.breaker.record_failure(deadline=True)
                if backend.platform.events is not None:
                    backend.platform.events.emit(
                        "federation", "shard_tick_deadline",
                        shard=backend.shard_id,
                        budget_s=self.tick_budget_s)
        self.admin.advance()
        if self.operator is not None:
            self.operator.step()
        self.reconciler.step()

    def run_for(self, sim_seconds: float):
        n = int(sim_seconds / self.shards[0].tick_period)
        for _ in range(n):
            self.tick()

    # -- chaos ------------------------------------------------------------
    def shard_crash(self, shard: int):
        self.backends[shard].crash()

    def shard_restart(self, shard: int):
        self.backends[shard].restart()

    def api_crash(self, replica: Optional[int] = None):
        targets = (self.api_replicas if replica is None
                   else [self.api_replicas[replica]])
        for r in targets:
            r.alive = False

    def api_restart(self, replica: Optional[int] = None):
        targets = (self.api_replicas if replica is None
                   else [self.api_replicas[replica]])
        for r in targets:
            if not r.alive:
                r.restart()
