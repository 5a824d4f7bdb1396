"""The workloads reconciler: converge applied manifests, one Federation tick
at a time.

The port's copy of the reference's ``repro/workloads/reconciler.py``, unchanged.

Same architecture as the autonomous operator (:mod:`repro_torch.obs.operator`),
deliberately: :class:`ReconcilerPolicy` is a *pure* state machine —
``decide(obs)`` maps an observation dict to a list of decision dicts with
no I/O, no clock, no RNG, and every enumeration canonically sorted, so the
decision journal is a deterministic function of the observed state no
matter how the observation was assembled (the property test replays a
trace under shuffled orderings and asserts identical journals, and a
steady-state observation decides *nothing*, which is the apply-twice
idempotence the tests pin). :class:`WorkloadReconciler` wraps it with
sensing and acting:

  * **sense** — drain each live shard's event bus through a private
    cursor for ``job_completed`` / ``job_failed`` terminal notices (the
    EventBus is the primary gate, per the paper's event-driven Guardian),
    backstopped by reading tracked jobs' statuses from the metastore
    under the shard read lock so a ring-compacted bus can never stall a
    pipeline; snapshot every manifest's spec + status;
  * **decide** — pipelines as DAGs (a stage submits when all of its
    ``after`` deps are DONE; terminal job events gate successors; a
    failed stage retries ``retries:`` times and then fails, skipping its
    descendants and degrading the pipeline), recurring jobs on a
    tick-based schedule with ``overlap: skip | allow | replace``, and
    services as slot→replica maps healed toward ``replicas:``;
  * **act** — every mutation goes through the same doors a client would
    use: stage jobs and serving replicas are v1 gateway submits (with
    ``wl/…`` idempotency keys, so a crashed-and-reconverging reconciler
    re-submits into the dedup window instead of duplicating work), child
    Services a pipeline materializes are plane ``apply`` calls, teardown
    is v1 ``cancel``. Each act is journaled as a ``workload_*`` platform
    event; ready serving replicas accrue ``serving_replica_seconds``
    into their tenant's shard meter every tick.

Lock order is plane mutex → shard lock, identical to the plane verbs, so
a wire ``apply`` and a reconcile step serialize instead of deadlocking.
"""

from __future__ import annotations

import collections
import copy
import threading
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set

# Decision/event vocabulary. Every act the reconciler (or the plane, for
# apply/delete) takes is journaled on the event bus under one of these
# kinds — part of PLATFORM_EVENT_KINDS (docs/api.md pins them).
WORKLOAD_EVENT_KINDS = (
    "workload_applied",
    "workload_deleted",
    "workload_stage_submitted",
    "workload_stage_failed",
    "workload_pipeline_done",
    "workload_pipeline_degraded",
    "workload_recurring_run",
    "workload_recurring_skipped",
    "workload_service_scaled",
    "workload_service_ready",
    "workload_service_degraded",
)

# Stage states a pipeline DAG node moves through (terminal: DONE /
# FAILED / SKIPPED). Documented in docs/api.md's workloads section.
STAGE_TERMINAL = ("DONE", "FAILED", "SKIPPED")


@dataclass(frozen=True)
class ReconcilerConfig:
    """Knobs for the workloads reconciler (docs/architecture.md)."""

    replica_sim_duration: float = 1e9   # serving replicas run "forever"
    max_decisions: int = 400            # decision-journal ring size
    event_page: int = 5000              # bus events drained per page


def _outcome(job_id: Optional[str], jobs: Dict[str, str],
             completed: Set[str], failed: Set[str]) -> Optional[str]:
    """Terminal outcome of a tracked job: "completed" / "failed", or
    ``None`` while it runs (or while its shard is unreachable — an
    outage must not look like a failure and trigger spurious retries).
    Bus events are consulted first, metastore status second."""
    if job_id is None:
        return None
    if job_id in failed:
        return "failed"
    if job_id in completed:
        return "completed"
    st = jobs.get(job_id)
    if st == "COMPLETED":
        return "completed"
    if st == "FAILED":
        return "failed"
    return None


class ReconcilerPolicy:
    """Pure decision core: ``decide(obs)`` -> list of decision dicts."""

    def __init__(self, config: ReconcilerConfig):
        self.config = config
        self.tick = 0
        self.decisions: Deque[dict] = collections.deque(
            maxlen=config.max_decisions)

    def _log(self, decision: dict) -> dict:
        decision = {"tick": self.tick, **decision}
        self.decisions.append(decision)
        return decision

    def decide(self, obs: dict) -> List[dict]:
        self.tick = obs["tick"]
        jobs = obs["jobs"]
        completed = frozenset(obs["completed"])
        failed = frozenset(obs["failed"])
        manifests = sorted(obs["manifests"],
                           key=lambda m: (m["tenant"], m["name"]))
        by_key = {(m["tenant"], m["name"]): m for m in manifests}
        out: List[dict] = []
        for m in manifests:
            if m["kind"] == "Pipeline":
                self._decide_pipeline(m, by_key, jobs, completed, failed,
                                      out)
            elif m["kind"] == "RecurringJob":
                self._decide_recurring(m, jobs, completed, failed, out)
            else:
                self._decide_service(m, jobs, completed, failed, out)
        return out

    # -- pipelines ---------------------------------------------------------
    def _decide_pipeline(self, m, by_key, jobs, completed, failed, out):
        st = m["status"]
        if st["phase"] in ("SUCCEEDED", "DEGRADED"):
            return
        base = {"tenant": m["tenant"], "name": m["name"]}
        stages = m["spec"]["stages"]   # validation order = submit order
        sst = st["stages"]
        for s in stages:
            cur = sst[s["name"]]
            if cur["state"] == "PENDING":
                dep_states = [sst[d]["state"] for d in s["after"]]
                if any(ds in ("FAILED", "SKIPPED") for ds in dep_states):
                    out.append(self._log({
                        **base, "action": "stage_skip", "stage": s["name"],
                        "reason": "an upstream stage failed"}))
                elif all(ds == "DONE" for ds in dep_states):
                    if s.get("service") is not None:
                        out.append(self._log({
                            **base, "action": "stage_service",
                            "stage": s["name"]}))
                    else:
                        out.append(self._log({
                            **base, "action": "stage_submit",
                            "stage": s["name"],
                            "attempt": cur["attempts"]}))
            elif cur["state"] == "RUNNING":
                if s.get("service") is not None:
                    child = by_key.get((m["tenant"], cur.get("service")))
                    if child is None:
                        out.append(self._log({
                            **base, "action": "stage_failed",
                            "stage": s["name"], "job": None,
                            "reason": "materialized Service was deleted"}))
                    elif child["status"].get("phase") == "RUNNING":
                        out.append(self._log({
                            **base, "action": "stage_done",
                            "stage": s["name"]}))
                    continue
                oc = _outcome(cur["job"], jobs, completed, failed)
                if oc == "completed":
                    out.append(self._log({
                        **base, "action": "stage_done",
                        "stage": s["name"]}))
                elif oc == "failed":
                    if cur["attempts"] <= s["retries"]:
                        out.append(self._log({
                            **base, "action": "stage_retry",
                            "stage": s["name"], "attempt": cur["attempts"],
                            "reason": (f"attempt {cur['attempts']} of "
                                       f"{1 + s['retries']} failed")}))
                    else:
                        out.append(self._log({
                            **base, "action": "stage_failed",
                            "stage": s["name"], "job": cur["job"],
                            "reason": (f"failed after {cur['attempts']} "
                                       f"attempts (retries: "
                                       f"{s['retries']})")}))
        states = [sst[s["name"]]["state"] for s in stages]
        if st["phase"] == "RUNNING" and all(
                x in STAGE_TERMINAL for x in states):
            if all(x == "DONE" for x in states):
                out.append(self._log({
                    **base, "action": "pipeline_done"}))
            else:
                out.append(self._log({
                    **base, "action": "pipeline_degraded",
                    "failed_stages": sorted(
                        s["name"] for s in stages
                        if sst[s["name"]]["state"] != "DONE")}))

    # -- recurring jobs ----------------------------------------------------
    def _decide_recurring(self, m, jobs, completed, failed, out):
        st = m["status"]
        if st["phase"] != "ACTIVE":
            return
        base = {"tenant": m["tenant"], "name": m["name"]}
        spec = m["spec"]
        live = sorted(j for j in st["jobs"]
                      if _outcome(j, jobs, completed, failed) is None)
        done = sorted(j for j in st["jobs"] if j not in set(live))
        max_runs = spec.get("max_runs")
        if max_runs is not None and st["runs"] >= max_runs:
            if not live:
                out.append(self._log({
                    **base, "action": "recurring_done",
                    "reason": f"max_runs {max_runs} reached"}))
            return
        due = (st["last_run_tick"] is None
               or self.tick - st["last_run_tick"] >= spec["every_ticks"])
        if not due:
            return
        if live and spec["overlap"] == "skip":
            out.append(self._log({
                **base, "action": "recurring_skip",
                "live": live, "reason": "previous run still live"}))
        elif live and spec["overlap"] == "replace":
            out.append(self._log({
                **base, "action": "recurring_replace", "cancel": live,
                "prune": done, "run": st["runs"]}))
        else:
            out.append(self._log({
                **base, "action": "recurring_run", "prune": done,
                "run": st["runs"]}))

    # -- services ----------------------------------------------------------
    def _decide_service(self, m, jobs, completed, failed, out):
        st = m["status"]
        base = {"tenant": m["tenant"], "name": m["name"]}
        desired = m["spec"]["replicas"]
        replicas = st["replicas"]
        for slot in range(desired):
            k = str(slot)
            job = replicas.get(k)
            if job is None:
                out.append(self._log({
                    **base, "action": "replica_start", "slot": k,
                    "reason": "slot empty"}))
                continue
            # a serving replica must never exit: any terminal outcome in
            # a slot is a dead replica — restart it. (An unreachable
            # shard reports nothing, and nothing is not an outcome.)
            oc = _outcome(job, jobs, completed, failed)
            if oc is not None:
                out.append(self._log({
                    **base, "action": "replica_start", "slot": k,
                    "replaces": job,
                    "reason": f"replica job ended ({oc})"}))
        extra = sorted((k for k in replicas if int(k) >= desired), key=int)
        for k in extra:
            out.append(self._log({
                **base, "action": "replica_stop", "slot": k,
                "job": replicas[k],
                "reason": f"scaled down to {desired}"}))
        ready = sorted((k for k in replicas
                        if int(k) < desired
                        and jobs.get(replicas[k]) == "PROCESSING"),
                       key=int)
        if desired == 0:
            phase = "STOPPED"
        elif len(ready) == desired:
            phase = "RUNNING"
        elif st["phase"] in ("RUNNING", "DEGRADED"):
            phase = "DEGRADED"
        else:
            phase = "PENDING"
        if ready != st["ready_slots"] or phase != st["phase"]:
            out.append(self._log({
                **base, "action": "service_status", "ready": ready,
                "phase": phase, "prev_phase": st["phase"]}))


class WorkloadReconciler:
    """Sense → decide → act wrapper stepped from ``Federation.tick`` after
    ``admin.advance()`` and the operator — never from inside a shard tick
    (it submits through the gateway, which takes shard locks)."""

    def __init__(self, fed, plane, config: Optional[ReconcilerConfig] = None):
        self.fed = fed
        self.plane = plane
        self.config = config or ReconcilerConfig()
        self.policy = ReconcilerPolicy(self.config)
        self._mutex = threading.RLock()
        self._ticks = 0
        self._cursors: Dict[str, int] = {}   # shard_id -> bus cursor
        self._completed: Set[str] = set()    # event-derived terminal sets
        self._failed: Set[str] = set()

    # -- the loop -----------------------------------------------------------
    def step(self) -> List[dict]:
        """One reconcile pass over every applied manifest."""
        with self.plane._mutex:
            with self._mutex:
                obs = self._sense()
                decisions = self.policy.decide(obs)
                for d in decisions:
                    self._act(d)
                self._meter_serving()
                return decisions

    def journal(self) -> List[dict]:
        with self._mutex:
            return [dict(d) for d in self.policy.decisions]

    def status_view(self) -> dict:
        from repro_torch.api.types import ADMIN_API_VERSION
        with self.plane._mutex:
            with self._mutex:
                return {"api_version": ADMIN_API_VERSION,
                        "tick": self._ticks,
                        "resources": len(self.plane.records),
                        "decisions": [dict(d)
                                      for d in self.policy.decisions]}

    # -- sensing ------------------------------------------------------------
    def _sense(self) -> dict:
        self._ticks += 1
        # 1. event gate: drain terminal job notices from every live bus.
        for b in sorted(self.fed.router.backends, key=lambda b: b.shard_id):
            if not b.alive:
                continue  # cursor kept; catch up if the shard revives
            bus = b.platform.events
            cur = self._cursors.get(b.shard_id, -1)
            while True:
                evs, cur, _missed = bus.read_since(
                    cur, self.config.event_page, None, None)
                for e in evs:
                    if e.kind == "job_completed":
                        self._completed.add(e.fields.get("job"))
                    elif e.kind == "job_failed":
                        self._failed.add(e.fields.get("job"))
                if len(evs) < self.config.event_page:
                    break
            self._cursors[b.shard_id] = cur
        # 2. status backstop: read every tracked job's metastore record
        # under its home shard's read lock (ring compaction can drop
        # events; a pipeline must still converge).
        tracked_by_tenant: Dict[str, Set[str]] = {}
        all_tracked: Set[str] = set()
        for rec in self.plane.records.values():
            ids = rec.tracked_jobs()
            all_tracked.update(ids)
            if ids:
                tracked_by_tenant.setdefault(
                    rec.tenant, set()).update(ids)
        self._completed &= all_tracked
        self._failed &= all_tracked
        jobs: Dict[str, str] = {}
        for tenant in sorted(tracked_by_tenant):
            try:
                b = self.fed.router.shard_for(tenant)
            except Exception:
                continue
            if not b.alive:
                continue
            with b.read_locked():
                meta = b.platform.meta
                for j in sorted(tracked_by_tenant[tenant]):
                    r = meta.get(j)
                    if r is not None:
                        jobs[j] = r.status.value
        manifests = [{"tenant": rec.tenant, "name": rec.name,
                      "kind": rec.kind, "generation": rec.generation,
                      "spec": copy.deepcopy(rec.spec),
                      "status": copy.deepcopy(rec.status)}
                     for rec in self.plane.records.values()]
        return {"tick": self._ticks, "manifests": manifests, "jobs": jobs,
                "completed": sorted(self._completed),
                "failed": sorted(self._failed)}

    # -- acting -------------------------------------------------------------
    def _act(self, d: dict):
        from repro_torch.api.types import ApiError
        try:
            self._dispatch(d)
        except ApiError as exc:
            # The gateway refused (quota exhausted, admission preempted
            # the window, shard down mid-act…). Journal and move on: the
            # next tick re-observes and re-decides.
            self.policy._log({"action": "act_failed",
                              "attempted": d["action"],
                              "tenant": d.get("tenant"),
                              "name": d.get("name"), "error": str(exc),
                              "reason": "v1/plane verb rejected the act"})

    def _dispatch(self, d: dict):
        rec = self.plane.records.get((d["tenant"], d["name"]))
        if rec is None:
            return  # deleted between decide and act
        fn = getattr(self, "_act_" + d["action"])
        fn(rec, d)

    def _submit(self, manifest, idempotency_key: str) -> str:
        from repro_torch.api.types import SubmitRequest
        resp = self.plane._api.submit(
            self.plane._key,
            SubmitRequest(manifest=manifest,
                          idempotency_key=idempotency_key))
        return resp.job_id

    def _cancel(self, job_id: str):
        from repro_torch.api.types import ApiError
        try:
            self.plane._api.cancel(self.plane._key, job_id)
        except ApiError:
            pass  # already terminal / unknown / shard down

    # stage verbs
    def _stage(self, rec, name):
        return next(s for s in rec.spec["stages"] if s["name"] == name)

    def _act_stage_submit(self, rec, d):
        from repro_torch.workloads.manifest import job_manifest_for
        s = self._stage(rec, d["stage"])
        jm = job_manifest_for(s["job"], rec.tenant,
                              f"{rec.name}-{d['stage']}")
        idem = (f"wl/{rec.tenant}/{rec.name}/g{rec.generation}"
                f"/{d['stage']}/a{d['attempt']}")
        job_id = self._submit(jm, idem)
        cur = rec.status["stages"][d["stage"]]
        cur.update(state="RUNNING", job=job_id,
                   attempts=d["attempt"] + 1)
        if rec.status["phase"] == "PENDING":
            rec.status["phase"] = "RUNNING"
        self.plane._emit("workload_stage_submitted", rec.tenant,
                         name=rec.name, stage=d["stage"], job=job_id,
                         attempt=d["attempt"] + 1)

    _act_stage_retry = _act_stage_submit

    def _act_stage_service(self, rec, d):
        s = self._stage(rec, d["stage"])
        child = f"{rec.name}-{d['stage']}"
        self.plane.apply({"kind": "Service", "name": child,
                          "tenant": rec.tenant, **s["service"]},
                         owner=(rec.tenant, rec.name))
        cur = rec.status["stages"][d["stage"]]
        cur.update(state="RUNNING", service=child)
        if rec.status["phase"] == "PENDING":
            rec.status["phase"] = "RUNNING"

    def _act_stage_done(self, rec, d):
        rec.status["stages"][d["stage"]]["state"] = "DONE"

    def _act_stage_skip(self, rec, d):
        rec.status["stages"][d["stage"]]["state"] = "SKIPPED"

    def _act_stage_failed(self, rec, d):
        rec.status["stages"][d["stage"]]["state"] = "FAILED"
        self.plane._emit("workload_stage_failed", rec.tenant,
                         name=rec.name, stage=d["stage"],
                         job=d.get("job"), reason=d.get("reason", ""))

    def _act_pipeline_done(self, rec, d):
        rec.status["phase"] = "SUCCEEDED"
        self.plane._emit("workload_pipeline_done", rec.tenant,
                         name=rec.name, generation=rec.generation)

    def _act_pipeline_degraded(self, rec, d):
        rec.status["phase"] = "DEGRADED"
        self.plane._emit("workload_pipeline_degraded", rec.tenant,
                         name=rec.name, generation=rec.generation,
                         failed_stages=d.get("failed_stages", []))

    # recurring verbs
    def _act_recurring_run(self, rec, d):
        from repro_torch.workloads.manifest import job_manifest_for
        for j in d.get("cancel", ()):
            self._cancel(j)
        run = d["run"]
        jm = job_manifest_for(rec.spec["job"], rec.tenant,
                              f"{rec.name}-run{run}")
        job_id = self._submit(jm, f"wl/{rec.tenant}/{rec.name}/run{run}")
        drop = set(d.get("prune", ())) | set(d.get("cancel", ()))
        st = rec.status
        st["jobs"] = [j for j in st["jobs"] if j not in drop] + [job_id]
        st["runs"] = run + 1
        st["last_run_tick"] = self.policy.tick
        self.plane._emit("workload_recurring_run", rec.tenant,
                         name=rec.name, run=run, job=job_id,
                         replaced=sorted(d.get("cancel", ())))

    _act_recurring_replace = _act_recurring_run

    def _act_recurring_skip(self, rec, d):
        st = rec.status
        st["skipped"] += 1
        st["last_run_tick"] = self.policy.tick
        self.plane._emit("workload_recurring_skipped", rec.tenant,
                         name=rec.name, live=d.get("live", []))

    def _act_recurring_done(self, rec, d):
        rec.status["phase"] = "DONE"

    # service verbs
    def _act_replica_start(self, rec, d):
        from repro_torch.core.types import JobManifest
        slot = d["slot"]
        inc = rec.status.setdefault("incarnations", {})
        n = inc.get(slot, 0)
        jm = JobManifest(
            name=f"{rec.name}-r{slot}", tenant=rec.tenant, n_learners=1,
            chips_per_learner=rec.spec["chips_per_replica"],
            tier=rec.spec["tier"],
            sim_duration=self.config.replica_sim_duration)
        job_id = self._submit(
            jm, f"wl/{rec.tenant}/{rec.name}/r{slot}/i{n}")
        rec.status["replicas"][slot] = job_id
        inc[slot] = n + 1
        self.plane._emit("workload_service_scaled", rec.tenant,
                         name=rec.name, slot=slot, job=job_id,
                         replicas=rec.spec["replicas"])

    def _act_replica_stop(self, rec, d):
        slot = d["slot"]
        job = rec.status["replicas"].pop(slot, None)
        if slot in rec.status["ready_slots"]:
            rec.status["ready_slots"].remove(slot)
        if job:
            self._cancel(job)
        self.plane._emit("workload_service_scaled", rec.tenant,
                         name=rec.name, slot=slot, job=None,
                         replicas=rec.spec["replicas"])

    def _act_service_status(self, rec, d):
        prev = rec.status["phase"]
        rec.status["ready_slots"] = list(d["ready"])
        rec.status["phase"] = d["phase"]
        if d["phase"] == "RUNNING" and prev != "RUNNING":
            self.plane._emit("workload_service_ready", rec.tenant,
                             name=rec.name, ready=list(d["ready"]))
        elif d["phase"] == "DEGRADED" and prev != "DEGRADED":
            self.plane._emit("workload_service_degraded", rec.tenant,
                             name=rec.name, ready=list(d["ready"]))

    # -- serving metering ---------------------------------------------------
    def _meter_serving(self):
        """Ready replicas bill ``serving_replica_seconds`` per tick into
        their tenant's shard meter (same cadence chip_seconds accrue)."""
        for (tenant, _name), rec in sorted(self.plane.records.items()):
            if rec.kind != "Service":
                continue
            n = len(rec.status.get("ready_slots", []))
            if not n:
                continue
            try:
                b = self.fed.router.shard_for(tenant)
            except Exception:
                continue
            if b.alive and not getattr(b, "retired", False):
                b.platform.meter.bump(
                    tenant, "serving_replica_seconds",
                    n * b.platform.tick_period)
