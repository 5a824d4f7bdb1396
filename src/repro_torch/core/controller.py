"""Controller helper (FfDL §3.8 'Detecting Failure or Completion of Learner
Processes' + 'Reliable Status Updates').

Runs in the helper pod, isolated from learners but sharing the job's NFS
volume. Each tick it reads learner status/exit files from the volume and
records per-learner status in etcd (under a lease so stale state vanishes if
the whole job disappears). The Guardian watches etcd and aggregates.

Crash-resilience contract reproduced from the paper:
  * controller crash → K8s restarts it; statuses re-read from NFS (no loss);
  * Guardian crash → etcd still has per-learner statuses;
  * learner crash → its exit file (non-zero code) is the detection signal.
"""

from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.executor import JobVolume
from repro_torch.core.kvstore import EtcdLike
from repro_torch.core.types import EventLog


class Controller:
    LEASE_TTL = 30.0

    def __init__(self, job_id: str, n_learners: int, volume: JobVolume,
                 etcd: EtcdLike, clock, events: EventLog):
        self.job_id = job_id
        self.n_learners = n_learners
        self.volume = volume
        self.etcd = etcd
        self.clock = clock
        self.events = events
        self.alive = True
        self._lease: Optional[int] = None

    def _ensure_lease(self):
        if self._lease is None or not self.etcd.keepalive(self._lease):
            self._lease = self.etcd.grant_lease(self.LEASE_TTL)

    def crash(self):
        self.alive = False

    def restart(self):
        """K8s restart: stateless — everything is re-read from NFS."""
        self.alive = True
        self._lease = None

    def tick(self):
        if not self.alive:
            return
        try:
            self._ensure_lease()
            for k in range(self.n_learners):
                raw = self.volume.read(f"status/learner-{k}")
                if raw is not None:
                    self.etcd.put(f"/jobs/{self.job_id}/learners/{k}/status",
                                  json.loads(raw), lease_id=self._lease)
                exit_raw = self.volume.read(f"exit/learner-{k}")
                if exit_raw is not None:
                    self.etcd.put(f"/jobs/{self.job_id}/learners/{k}/exit",
                                  json.loads(exit_raw), lease_id=self._lease)
        except (IOError, ConnectionError) as e:
            self.events.emit("controller", "status_relay_error",
                             job=self.job_id, error=str(e))
