"""Admission control + priority management (FfDL §3.6).

"Given that there is no overcommitment, admission control becomes
necessary; there is a component above FfDL that performs AC — based on
quotas for internal users [...] the AC component also pre-empts 2 job types
as necessary: (1) free users during heavy load, and (2) user A exceeded
their quota; their job was scheduled because user B wasn't using their
quota; user B subsequently wants to use his quota."

Implemented: per-tenant chip quotas; over-quota jobs admitted
opportunistically when idle capacity exists (marked preemptible);
reclamation preempts over-quota jobs of other tenants (HALT → checkpoint →
requeue); free-tier jobs preempted under heavy load when paid jobs queue.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.types import EventLog, JobManifest, JobStatus, gang_chips

HEAVY_LOAD_UTIL = 0.9


@dataclass
class Tenant:
    name: str
    quota_chips: int
    tier: str = "paid"


class AdmissionController:
    def __init__(self, platform, events: EventLog):
        self.p = platform
        self.events = events
        self.tenants: dict[str, Tenant] = {}
        # job_id → True if admitted above quota (preemptible on reclaim)
        self.over_quota: dict[str, bool] = {}

    def register_tenant(self, name: str, quota_chips: int, tier: str = "paid"):
        self.tenants[name] = Tenant(name, quota_chips, tier)

    def unregister_tenant(self, name: str):
        """Drop a tenant's quota (v2 admin tenant delete): its submissions
        fall back to the 'no quota configured' open admission."""
        self.tenants.pop(name, None)

    def _tenant_usage(self, tenant: str) -> int:
        """Chips held by a tenant's active (non-terminal, non-halted) jobs."""
        used = 0
        for rec in self.p.meta.jobs(tenant=tenant):
            if rec.status in (JobStatus.QUEUED, JobStatus.DEPLOYING,
                              JobStatus.DOWNLOADING, JobStatus.PROCESSING,
                              JobStatus.STORING, JobStatus.RESUMED,
                              JobStatus.PENDING):
                used += gang_chips(rec.manifest)
        return used

    def check(self, manifest: JobManifest) -> tuple[bool, str]:
        """Admit or reject a submission. Over-quota → opportunistic admit
        when the cluster has idle capacity, else reject."""
        tenant = self.tenants.get(manifest.tenant)
        if tenant is None:
            return True, "no quota configured"
        need = gang_chips(manifest)
        usage = self._tenant_usage(manifest.tenant)
        if usage + need <= tenant.quota_chips:
            return True, "within quota"
        idle = self.p.cluster.total_chips - self.p.cluster.used_chips
        if idle >= need:
            self.events.emit("admission", "over_quota_admit",
                             tenant=manifest.tenant, chips=need)
            return True, "over quota (opportunistic)"
        return False, (f"quota exceeded: {usage}+{need} > "
                       f"{tenant.quota_chips} and no idle capacity")

    def mark(self, job_id: str, manifest: JobManifest):
        tenant = self.tenants.get(manifest.tenant)
        if tenant is None:
            return
        usage = self._tenant_usage(manifest.tenant)
        self.over_quota[job_id] = usage > tenant.quota_chips

    # -- preemption ------------------------------------------------------
    def _active_jobs(self):
        for rec in self.p.meta.jobs():
            if rec.status in (JobStatus.DOWNLOADING, JobStatus.PROCESSING,
                              JobStatus.STORING, JobStatus.RESUMED):
                yield rec

    def tick(self):
        """Reclaim quota + heavy-load free-tier preemption."""
        queued = [r for r in self.p.meta.jobs()
                  if r.status == JobStatus.QUEUED]
        if not queued:
            return
        util = self.p.cluster.utilization()
        for waiter in queued:
            w_tenant = self.tenants.get(waiter.manifest.tenant)
            if w_tenant is None:
                continue
            w_usage = self._tenant_usage(waiter.manifest.tenant)
            within_quota = w_usage <= w_tenant.quota_chips
            if not within_quota:
                continue  # over-quota jobs don't trigger preemption
            need = gang_chips(waiter.manifest)
            free = self.p.cluster.total_chips - self.p.cluster.used_chips
            if free >= need:
                continue  # scheduler will get to it
            # candidates: (1) over-quota jobs of other tenants,
            # (2) free-tier jobs under heavy load
            victims = []
            for rec in self._active_jobs():
                if rec.manifest.tenant == waiter.manifest.tenant:
                    continue
                if self.over_quota.get(rec.job_id):
                    victims.append((0, rec))
                elif rec.manifest.tier == "free" and util >= HEAVY_LOAD_UTIL \
                        and waiter.manifest.tier == "paid":
                    victims.append((1, rec))
            victims.sort(key=lambda t: (t[0], -t[1].submitted_at))
            reclaimed = 0
            for _, victim in victims:
                if free + reclaimed >= need:
                    break
                self.events.emit("admission", "preempt", job=victim.job_id,
                                 beneficiary=waiter.job_id,
                                 reason="quota_reclaim" if
                                 self.over_quota.get(victim.job_id)
                                 else "free_tier_heavy_load")
                # control-plane action: must work even with the API tier down
                self.p._halt_internal(victim.job_id, requeue=True)
                reclaimed += gang_chips(victim.manifest)
