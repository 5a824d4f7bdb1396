"""Lifecycle Manager (FfDL §3.3): owns jobs from submission to completion.

The LCM is deliberately thin — it stores no per-job deployment state (that's
the Guardian's job, precisely so the LCM isn't a single point of failure).
Its tick reconciles the metastore against the set of live guardians: any
PENDING/RESUMED job without a guardian gets one. Because reconciliation is
metadata-driven, an LCM crash loses nothing: the replacement replays the
same scan (the paper's 'submitted jobs are never lost' property).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.guardian import Guardian
from repro_torch.core.types import EventLog, JobStatus, TERMINAL


class LifecycleManager:
    GUARDIAN_CREATE_LATENCY = 1.5  # "less than 3s in our experiments"

    def __init__(self, platform, events: EventLog):
        self.p = platform
        self.events = events
        self.alive = True
        self._creating: set[str] = set()

    def crash(self):
        self.alive = False
        self._creating = set()  # in-flight creations lost; reconcile redoes

    def restart(self):
        self.alive = True
        self.events.emit("lcm", "lcm_restarted")

    def tick(self):
        if not self.alive:
            return
        for rec in self.p.meta.jobs():
            if rec.status in TERMINAL or rec.status == JobStatus.HALTED:
                continue
            if rec.job_id in self.p.guardians or rec.job_id in self._creating:
                continue
            self._creating.add(rec.job_id)
            job_id = rec.job_id

            def create(job_id=job_id):
                self._creating.discard(job_id)
                if job_id in self.p.guardians:
                    return  # idempotent: double-create is a no-op
                rec2 = self.p.meta.get(job_id)
                if rec2 is None or rec2.status in TERMINAL or \
                        rec2.status == JobStatus.HALTED:
                    return
                g = Guardian(job_id, rec2.manifest, platform=self.p)
                self.p.guardians[job_id] = g
                self.events.emit("lcm", "guardian_created", job=job_id)

            self.p.clock.call_later(self.GUARDIAN_CREATE_LATENCY, create)
