"""Guardian: per-job delegate for atomic deployment + monitoring (FfDL §3.3).

"The LCM launches a delegate for atomic deployment and further monitoring of
each DL job. [...] If the Guardian crashes in the middle of a job
deployment, K8s is guaranteed to restart it. The restarted Guardian will
roll back the previous partially deployed DL job and start a fresh
deployment process. In the presence of persistent failures, this process
will be repeated for a (configurable) number of times before the Guardian
gives up and marks the DL job in MongoDB as FAILED."

Deployment step machine (one step per tick, each can fail/crash):
  VOLUME → CREDS → SCHEDULE → CREATE_PODS → WAIT_RUNNING → MONITOR

Monitoring aggregates per-learner etcd statuses into the job status
(metastore), restarts crashed learners (stateful-set semantics, resume from
checkpoint), re-places evicted learners after node failures (elastic
recovery), and garbage-collects everything at completion.
"""

from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.controller import Controller
from repro_torch.core.executor import JobVolume, LearnerContext, make_learner
from repro_torch.core.helpers import LogCollector
from repro_torch.core.scheduler import GangRequest
from repro_torch.core.types import (
    EventLog,
    JobManifest,
    JobStatus,
    Pod,
    PodPhase,
    TERMINAL,
)

DEPLOY_STAGES = ["VOLUME", "CREDS", "SCHEDULE", "CREATE_PODS",
                 "WAIT_RUNNING", "MONITOR", "GC_DONE"]


class Guardian:
    STAGE_LATENCY = {"VOLUME": 2.0, "CREDS": 1.0, "CREATE_PODS": 1.0}

    def __init__(self, job_id: str, manifest: JobManifest, *, platform):
        self.job_id = job_id
        self.manifest = manifest
        self.p = platform  # wiring: cluster, scheduler, etcd, meta, ...
        self.stage = "VOLUME"
        self.alive = True
        self.volume: Optional[JobVolume] = None
        self.gang: Optional[GangRequest] = None
        self.pods: list[Pod] = []
        self.helper_pod: Optional[Pod] = None
        self.controller: Optional[Controller] = None
        self.collector: Optional[LogCollector] = None
        self.runtimes: dict[int, object] = {}  # learner idx → runtime
        self._stage_entered = platform.clock.now()
        self._halt_requested = False
        self._was_restarted = False
        # straggler tracking: learner idx → (progress value, last-change ts)
        self._progress: dict[int, tuple] = {}

    # -- crash semantics ---------------------------------------------------
    def crash(self):
        self.alive = False
        self.p.events.emit("guardian", "guardian_crashed", job=self.job_id)

    def restart(self):
        """K8s Job restart. Mid-deploy → rollback + fresh deploy."""
        self.alive = True
        self._was_restarted = True
        self.p.events.emit("guardian", "guardian_restarted", job=self.job_id)
        if self.stage not in ("MONITOR", "GC_DONE"):
            rec = self.p.meta.get(self.job_id)
            rec.deploy_retries += 1
            if rec.deploy_retries > self.manifest.max_deploy_retries:
                self._fail("deploy retries exhausted")
                return
            self._rollback()
            self.stage = "VOLUME"
            self._stage_entered = self.p.clock.now()

    def _rollback(self):
        """Undo a partial deployment: no zombies, no leaked chips."""
        for pod in self.pods:
            self.p.cluster.delete_pod(pod.name, reason="rollback")
        if self.helper_pod is not None:
            self.p.cluster.delete_pod(self.helper_pod.name, reason="rollback")
        self.pods = []
        self.helper_pod = None
        self.runtimes = {}
        self.p.scheduler.release(self.job_id)
        self.gang = None
        if self.volume is not None:
            self.volume.provisioned = False
            self.volume = None
        self.p.events.emit("guardian", "rollback", job=self.job_id)

    # -- terminal transitions ---------------------------------------------
    def _fail(self, msg: str):
        self._teardown()
        self.p.meta.update_status(self.job_id, JobStatus.FAILED, msg)
        rec = self.p.meta.get(self.job_id)
        rec.finished_at = self.p.clock.now()
        self.p.events.emit("guardian", "job_failed", job=self.job_id, msg=msg)
        self.stage = "GC_DONE"

    def _complete(self):
        self._teardown()
        self.p.meta.update_status(self.job_id, JobStatus.COMPLETED, "done")
        rec = self.p.meta.get(self.job_id)
        rec.finished_at = self.p.clock.now()
        self.p.events.emit("guardian", "job_completed", job=self.job_id)
        self.stage = "GC_DONE"

    def halt(self):
        """User/AC-initiated HALT: checkpoint boundary is the learner's
        latest checkpoint; pods stop, chips free, job resumable."""
        self._halt_requested = True

    def _do_halt(self):
        self._teardown()
        self.p.meta.update_status(self.job_id, JobStatus.HALTED, "halted")
        self.p.events.emit("guardian", "job_halted", job=self.job_id)
        self.stage = "GC_DONE"
        self._halt_requested = False

    def _teardown(self):
        """GC: pods deleted, gang released, job's etcd data erased (§3.2)."""
        for pod in self.pods:
            self.p.cluster.delete_pod(pod.name, reason="gc")
        if self.helper_pod is not None:
            self.p.cluster.delete_pod(self.helper_pod.name, reason="gc")
        self.p.scheduler.release(self.job_id)
        self.p.etcd.delete_prefix(f"/jobs/{self.job_id}/")
        self.runtimes = {}

    # -- deployment step machine -------------------------------------------
    def tick(self):
        if not self.alive or self.stage == "GC_DONE":
            return
        if self._halt_requested and self.stage == "MONITOR":
            self._do_halt()
            return
        handler = getattr(self, f"_stage_{self.stage.lower()}")
        handler()

    def _stage_elapsed(self) -> float:
        return self.p.clock.now() - self._stage_entered

    def _advance(self, stage: str):
        self.stage = stage
        self._stage_entered = self.p.clock.now()

    def _stage_volume(self):
        self.p.meta.update_status(self.job_id, JobStatus.DEPLOYING,
                                  "provisioning volume")
        if self._stage_elapsed() < self.STAGE_LATENCY["VOLUME"]:
            return
        if self.p.chaos.should_fail("volume_provision", self.job_id):
            self.p.events.emit("guardian", "volume_provision_failed",
                               job=self.job_id,
                               reason="persistentvolumeclaim not found")
            rec = self.p.meta.get(self.job_id)
            rec.deploy_retries += 1
            if rec.deploy_retries > self.manifest.max_deploy_retries:
                self._fail("volume provisioning failed")
            self._stage_entered = self.p.clock.now()  # retry
            return
        self.volume = self.p.volumes.setdefault(self.job_id,
                                                JobVolume(self.job_id))
        self.volume.provisioned = True
        self._advance("CREDS")

    def _stage_creds(self):
        if self._stage_elapsed() < self.STAGE_LATENCY["CREDS"]:
            return
        # bind per-tenant credentials for data/results buckets
        self.volume.write(".creds", json.dumps({
            "tenant": self.manifest.tenant,
            "data": self.manifest.data_bucket,
            "results": self.manifest.results_bucket}))
        self._advance("SCHEDULE")

    def _stage_schedule(self):
        if self.gang is None:
            self.gang = GangRequest(
                job_id=self.job_id, n_pods=self.manifest.n_learners,
                chips_per_pod=self.manifest.chips_per_learner,
                submitted_at=self.p.clock.now())
            self.p.scheduler.submit(self.gang)
            self.p.meta.update_status(self.job_id, JobStatus.QUEUED,
                                      "waiting for gang placement")
        if self.gang.placement is not None:
            rec = self.p.meta.get(self.job_id)
            if rec.scheduled_at is None:
                rec.scheduled_at = self.p.clock.now()
            self._advance("CREATE_PODS")

    def _stage_create_pods(self):
        if self._stage_elapsed() < self.STAGE_LATENCY["CREATE_PODS"]:
            return
        self.p.meta.update_status(self.job_id, JobStatus.DEPLOYING,
                                  "creating pods")
        ok = True
        for k, host in enumerate(self.gang.placement):
            pod = Pod(name=f"{self.job_id}-l{k}", job_id=self.job_id,
                      kind="learner", chips=self.manifest.chips_per_learner)
            if not self.p.cluster.bind_pod(pod, host):
                ok = False
                break
            self.pods.append(pod)
        if ok:
            helper = Pod(name=f"{self.job_id}-helper", job_id=self.job_id,
                         kind="helper", chips=0)
            # helper rides on the first learner's host (no chips needed)
            ok = self.p.cluster.bind_pod(helper, self.gang.placement[0])
            if ok:
                self.helper_pod = helper
        if not ok:
            # binding race (e.g. host died between placement and bind):
            # roll back and retry the whole deployment — atomicity.
            self.p.events.emit("guardian", "bind_failed", job=self.job_id)
            rec = self.p.meta.get(self.job_id)
            rec.deploy_retries += 1
            if rec.deploy_retries > self.manifest.max_deploy_retries:
                self._fail("pod binding failed repeatedly")
                return
            self._rollback()
            self._advance("VOLUME")
            return
        self.p.scheduler.confirm(self.job_id)
        # helper containers: controller + log collector
        self.controller = Controller(self.job_id, self.manifest.n_learners,
                                     self.volume, self.p.etcd, self.p.clock,
                                     self.p.events)
        self.collector = LogCollector(self.job_id, self.manifest.n_learners,
                                      self.volume, self.p.log_index,
                                      self.p.clock)
        self._advance("WAIT_RUNNING")

    def _stage_wait_running(self):
        if any(p.phase == PodPhase.FAILED for p in self.pods):
            self._rollback()
            self._advance("VOLUME")
            return
        if all(p.phase == PodPhase.RUNNING for p in self.pods) and \
                self.helper_pod.phase == PodPhase.RUNNING:
            for k, pod in enumerate(self.pods):
                self._spawn_runtime(k)
            self.p.meta.update_status(self.job_id, JobStatus.DOWNLOADING,
                                      "learners starting")
            self._advance("MONITOR")

    def _spawn_runtime(self, k: int, resume: bool = False):
        ctx = LearnerContext(
            job_id=self.job_id, learner_idx=k, manifest=self.manifest,
            volume=self.volume, clock=self.p.clock, events=self.p.events,
            objstore=self.p.objstore, device=self.p.device)
        rt = make_learner(ctx)
        self.runtimes[k] = rt
        rt.start(resume=resume)

    # -- monitoring ---------------------------------------------------------
    def _stage_monitor(self):
        # drive learner runtimes for pods that are Running
        for k, pod in enumerate(self.pods):
            rt = self.runtimes.get(k)
            if pod.phase == PodPhase.RUNNING and rt is not None:
                rt.tick()
        if self.controller:
            self.controller.tick()
        if self.collector:
            self.collector.tick()

        statuses = {}
        exits = {}
        try:
            for k in range(self.manifest.n_learners):
                st = self.p.etcd.get(f"/jobs/{self.job_id}/learners/{k}/status")
                ex = self.p.etcd.get(f"/jobs/{self.job_id}/learners/{k}/exit")
                if st:
                    statuses[k] = st
                if ex:
                    exits[k] = ex
        except ConnectionError:
            return  # etcd blip; keep last known state (resilience by design)

        # learner process failures (non-zero exit) → stateful-set restart
        for k, ex in exits.items():
            if ex["code"] != 0:
                pod = self.pods[k]
                rec = self.p.meta.get(self.job_id)
                rec.restarts += 1
                if rec.restarts > self.manifest.max_restarts:
                    self._fail(f"learner {k} failed (exit {ex['code']}) too "
                               "many times")
                    return
                self.p.events.emit("guardian", "learner_restart",
                                   job=self.job_id, learner=k,
                                   code=ex["code"])
                # clear stale exit/status, restart pod in place, resume
                self.volume.files.pop(f"exit/learner-{k}", None)
                self.p.etcd.delete(f"/jobs/{self.job_id}/learners/{k}/exit")
                self.p.cluster.restart_pod(pod.name)
                self._spawn_runtime(k, resume=True)
                self.p.meta.update_status(self.job_id, JobStatus.RESUMED,
                                          f"learner {k} restarted")
                return

        # evicted pods (node failure) → re-place on healthy hosts
        missing = [k for k, pod in enumerate(self.pods)
                   if pod.phase == PodPhase.DELETED]
        if missing:
            self._recover_evicted(missing)
            return

        # crashed-but-not-exited learner pods → restart (stateful set)
        for k, pod in enumerate(self.pods):
            if pod.phase == PodPhase.FAILED:
                rec = self.p.meta.get(self.job_id)
                rec.restarts += 1
                if rec.restarts > self.manifest.max_restarts:
                    self._fail(f"learner {k} pod crashed too many times")
                    return
                self.p.cluster.restart_pod(pod.name)
                self._spawn_runtime(k, resume=True)
                self.p.meta.update_status(self.job_id, JobStatus.RESUMED,
                                          f"learner {k} pod restarted")
                return

        # straggler mitigation (beyond-paper, DESIGN.md §2 scale-out):
        # a learner whose progress metric stalls while a peer advances is
        # restarted (resume-from-checkpoint), catching degraded-but-alive
        # nodes that exit-code monitoring misses.
        if self.manifest.straggler_timeout_s > 0 and \
                len(statuses) == self.manifest.n_learners:
            if self._check_stragglers(statuses):
                return

        # aggregate job status (paper: Guardian aggregates learner statuses)
        if exits and all(ex.get("code") == 0 for ex in exits.values()) \
                and len(exits) == self.manifest.n_learners:
            self._complete()
            return
        agg = self._aggregate(statuses)
        if agg is not None:
            self.p.meta.update_status(self.job_id, agg, "")
            rec = self.p.meta.get(self.job_id)
            rec.progress_step = max(
                (s.get("step", 0) for s in statuses.values()), default=0)

    def _check_stragglers(self, statuses: dict) -> bool:
        """Detect and restart stalled learners. True if one was restarted."""
        now = self.p.clock.now()
        advanced = False
        stalled: list = []
        for k, st in statuses.items():
            if st.get("status") != "PROCESSING":
                self._progress.pop(k, None)
                continue
            metric = st.get("step", 0) or st.get("progress", 0.0)
            prev = self._progress.get(k)
            if prev is None or metric > prev[0]:
                self._progress[k] = (metric, now)
                advanced = advanced or prev is not None
            elif now - prev[1] >= self.manifest.straggler_timeout_s:
                stalled.append(k)
        if not stalled or len(stalled) == len(statuses):
            return False  # nobody stalled, or global stall (not a straggler)
        k = stalled[0]
        rec = self.p.meta.get(self.job_id)
        rec.restarts += 1
        if rec.restarts > self.manifest.max_restarts:
            self._fail(f"straggler learner {k} exhausted restart budget")
            return True
        self.p.events.emit("guardian", "straggler_restart", job=self.job_id,
                           learner=k)
        self._progress.pop(k, None)
        self.p.cluster.restart_pod(self.pods[k].name)
        self._spawn_runtime(k, resume=True)
        self.p.meta.update_status(self.job_id, JobStatus.RESUMED,
                                  f"straggler learner {k} restarted")
        return True

    def _aggregate(self, statuses: dict) -> Optional[JobStatus]:
        if not statuses:
            return None
        vals = [s["status"] for s in statuses.values()]
        for stage in ("FAILED", "DOWNLOADING", "PROCESSING", "STORING"):
            if any(v == stage for v in vals):
                if stage == "FAILED":
                    return None  # handled via exit codes
                return JobStatus(stage)
        if all(v == "COMPLETED" for v in vals):
            return JobStatus.STORING  # final aggregation happens via exits
        return None

    def _recover_evicted(self, missing: list):
        """Node-failure recovery: re-place evicted learners on healthy hosts
        (elastic), falling back to full gang redeploy if infeasible."""
        rec = self.p.meta.get(self.job_id)
        rec.restarts += 1
        if rec.restarts > self.manifest.max_restarts:
            self._fail("node failures exhausted restart budget")
            return
        from repro_torch.core.bsa import bsa_place
        views = self.p.scheduler._host_views()
        assignment = bsa_place(views, len(missing),
                               self.manifest.chips_per_learner,
                               policy=self.p.scheduler.placement,
                               torus=self.p.cluster.torus,
                               rng=self.p.scheduler.rng)
        if assignment is None:
            # no capacity: full redeploy through the queue (gang semantics)
            self.p.events.emit("guardian", "gang_requeue", job=self.job_id)
            self._rollback()
            self._advance("VOLUME")
            return
        for k, host in zip(missing, assignment):
            pod = Pod(name=f"{self.job_id}-l{k}", job_id=self.job_id,
                      kind="learner", chips=self.manifest.chips_per_learner)
            if not self.p.cluster.bind_pod(pod, host):
                self._rollback()
                self._advance("VOLUME")
                return
            self.pods[k] = pod
            self.gang.placement[k] = host
            self.volume.files.pop(f"exit/learner-{k}", None)
            self.p.etcd.delete(f"/jobs/{self.job_id}/learners/{k}/exit")
            self._spawn_runtime(k, resume=True)
        # helper pod may have been evicted with the host — recreate it
        if self.helper_pod is not None and \
                self.helper_pod.phase == PodPhase.DELETED:
            helper = Pod(name=f"{self.job_id}-helper", job_id=self.job_id,
                         kind="helper", chips=0)
            if self.p.cluster.bind_pod(helper, self.gang.placement[0]):
                self.helper_pod = helper
        self.p.events.emit("guardian", "learners_replaced", job=self.job_id,
                           learners=missing)
        self.p.meta.update_status(self.job_id, JobStatus.RESUMED,
                                  f"learners {missing} re-placed after node "
                                  "failure")
