"""The port's FfDLPlatform (``repro_torch.core``) against the reference's
(``repro.core``) on the CPU.

Each scenario of tests/test_platform.py, tests/test_system.py and
tests/test_scheduler.py runs on both platforms from the same seed, with
simulated learners (``SimLearner``: no device, no JAX step), and must
leave the same trace on both:

  * every job's status history, (time, status, message);
  * the event log as (seq, time, component, kind, fields, tenant);
  * the metastore's write-ahead journal and each record's placement,
    restarts and progress;
  * every pod bound to a host, in order (the gang scheduler's and BSA's
    placements), and, for the scheduler scenarios, each placed gang;
  * the API tier's responses, as the wire carries them (dataclasses as
    dicts, enums as their values, errors as code, message and details).

Key strings and key ids are compared as they are: both platforms build
the v2 admin and workloads planes in the same order, and the workloads
plane draws its operator key at construction on both, so the keys they
issue agree in number and string.

Then real jobs through the port's platform: smollm-360m's tiny config on
``device="cpu"`` crashed at step 30 of 60 resumes to the uninterrupted
job's final state bit for bit, which is also the state of the same job run
through the reference's platform with the port's learner; a real job on a
platform whose device is the default (the card) fails where there is no
card, without training on the CPU; and recurrentgemma-2b's tiny config in
fp32 at head_dim 256 (a manifest's config overrides,
``chip_smoke.FP32_JOB``) through each package's platform and learner, from
the reference's initial weights, ends on the same status history and
per-tick losses within 1e-5.
"""

import dataclasses
import enum
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_mirror import one_thread  # noqa: F401 (a fixture)

import chip_smoke

import repro.api as rapi
import repro.core as rcore
from repro.core import bsa as rbsa
from repro.core import cluster as rcluster
from repro.core import guardian as rguardian
from repro.core import kvstore as rkv
from repro.core import metastore as rmeta
from repro.core import scheduler as rsched
from repro.core import types as rtypes
from repro.configs import base as rbase
from repro.models import steps as jsteps
from repro.utils import tree_flatten_with_paths as jflatten

import repro_torch.api as tapi
import repro_torch.core as tcore
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import bsa as tbsa
from repro_torch.core import cluster as tcluster
from repro_torch.core import executor as texecutor
from repro_torch.core import guardian as tguardian
from repro_torch.core import kvstore as tkv
from repro_torch.core import metastore as tmeta
from repro_torch.core import scheduler as tsched
from repro_torch.core import types as ttypes
from repro_torch.data.objectstore import MountedBucket, ObjectStore
from repro_torch.models import steps as tsteps


def _ns(api, core, meta, types, kv, cluster, sched, bsa, **platform_kw):
    return SimpleNamespace(
        FfDLPlatform=core.FfDLPlatform, ApiClient=api.ApiClient, ApiError=api.ApiError,
        ErrorCode=api.ErrorCode, JobManifest=core.JobManifest, JobStatus=core.JobStatus,
        ChaosConfig=core.ChaosConfig, MetaStore=meta.MetaStore, SimClock=types.SimClock,
        EventLog=types.EventLog, Pod=types.Pod, EtcdLike=kv.EtcdLike,
        ClusterModel=cluster.ClusterModel, GangScheduler=sched.GangScheduler,
        GangRequest=sched.GangRequest, K8sDefaultScheduler=sched.K8sDefaultScheduler,
        bsa_place=bsa.bsa_place, platform_kw=platform_kw)


REF = _ns(rapi, rcore, rmeta, rtypes, rkv, rcluster, rsched, rbsa)
PORT = _ns(tapi, tcore, tmeta, ttypes, tkv, tcluster, tsched, tbsa, device="cpu")


def wire(x):
    """``x`` as the wire would carry it."""
    if isinstance(x, enum.Enum):
        return wire(x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: wire(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {wire(k): wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [wire(v) for v in x]
    if hasattr(x, "code") and hasattr(x, "details"):  # ApiError
        return {"error": wire(x.code), "message": wire(str(x)), "details": wire(x.details)}
    return x


class Recording:
    """A v1 transport that records each verb's arguments and response."""

    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def __getattr__(self, verb):
        fn = getattr(self._inner, verb)

        def call(*args, **kwargs):
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                self._log.append((verb, wire(args), wire(kwargs), wire(e)))
                raise
            self._log.append((verb, wire(args), wire(kwargs), wire(out)))
            return out
        return call


class Trace:
    """What one scenario leaves on one side: its platforms and clusters,
    every bind, every placed gang, every API response, and what the
    scenario itself reports."""

    def __init__(self, ns):
        self.ns = ns
        self.platforms, self.binds, self.placed, self.wire, self.notes = [], [], [], [], []

    def spy_binds(self, cluster):
        bind = cluster.bind_pod

        def spy(pod, host_id):
            ok = bind(pod, host_id)
            self.binds.append((pod.name, host_id, ok))
            return ok
        cluster.bind_pod = spy

    def platform(self, **kw):
        p = self.ns.FfDLPlatform(**kw, **self.ns.platform_kw)
        self.spy_binds(p.cluster)
        self.platforms.append(p)
        return p

    def client(self, p, tenant="*"):
        c = self.ns.ApiClient.for_platform(p, tenant)
        c.transport = Recording(c.transport, self.wire)
        return c

    def cluster(self, n_hosts=4, chips=4):
        clock = self.ns.SimClock()
        events = self.ns.EventLog(clock)
        cluster = self.ns.ClusterModel(n_hosts, chips, clock,
                                       self.ns.EtcdLike(clock, events), events)
        self.spy_binds(cluster)
        self.platforms.append(SimpleNamespace(events=events, meta=None))
        return clock, events, cluster

    def scheduler(self, kind, cluster, events, **kw):
        sched = getattr(self.ns, kind)(cluster, events, **kw)
        sched.on_placed = lambda r: self.placed.append(
            (r.job_id, r.n_pods, r.chips_per_pod, list(r.placement or [])))
        return sched

    def observed(self):
        sides = []
        for p in self.platforms:
            side = {"events": [(e.seq, e.ts, e.component, e.kind, wire(e.fields), e.tenant)
                               for e in p.events.events]}
            if p.meta is not None:
                side["journal"] = wire(p.meta._journal)
                side["records"] = {
                    rec.job_id: wire((rec.status, rec.status_history, rec.placement,
                                      rec.restarts, rec.deploy_retries, rec.progress_step,
                                      rec.submitted_at, rec.scheduled_at, rec.finished_at))
                    for rec in p.meta.jobs()}
            sides.append(side)
        return {"sides": sides, "binds": self.binds, "placed": self.placed,
                "wire": self.wire, "notes": wire(self.notes)}


# --------------------------------------------------------------------------
# scenarios: tests/test_platform.py
# --------------------------------------------------------------------------

def sim_job(ns, name="j", **kw):
    kw.setdefault("n_learners", 2)
    kw.setdefault("chips_per_learner", 2)
    kw.setdefault("sim_duration", 120)
    return ns.JobManifest(name=name, **kw)


def until_processing(ns, p, j, n):
    for _ in range(n):
        p.tick()
        if p.meta.get(j).status == ns.JobStatus.PROCESSING:
            break


def sc_lifecycle(t, ns, tmp_path):
    p = t.platform(n_hosts=4, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns))
    assert p.run_until_terminal([j], max_sim_s=2000)
    hist = [s[1] for s in c.status_history(j)]
    order = [hist.index(s) for s in ["PENDING", "DEPLOYING", "DOWNLOADING", "PROCESSING",
                                     "STORING", "COMPLETED"]]
    assert order == sorted(order)
    assert c.status(j) == ns.JobStatus.COMPLETED and p.cluster.used_chips == 0


def sc_durable_before_ack(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, n_learners=1, chips_per_learner=1))
    p.api_crash()
    p.lcm.crash()
    for _ in range(5):
        p.tick()
    with pytest.raises(ns.ApiError):
        c.status(j)  # every replica is down
    p.api_restart()
    p.lcm.restart()
    assert p.run_until_terminal([j], max_sim_s=2000)
    assert c.status(j) == ns.JobStatus.COMPLETED


def sc_journal_recovery(t, ns, tmp_path):
    path = tmp_path / f"wal-{id(t)}.jsonl"
    m = ns.MetaStore(ns.SimClock(), journal_path=str(path))
    m.insert_job("job-1", sim_job(ns))
    m.update_status("job-1", ns.JobStatus.PROCESSING, "running")
    m2 = ns.MetaStore.recover(ns.SimClock(), str(path))
    rec = m2.get("job-1")
    assert rec.status == ns.JobStatus.PROCESSING and rec.manifest.n_learners == 2
    t.notes.append(path.read_text())
    t.notes.append((rec.status, rec.status_history, rec.manifest, m2._journal))


def sc_guardian_rollback(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns))
    for _ in range(20):
        p.tick()
        if j in p.guardians and p.guardians[j].stage in ("CREATE_PODS", "WAIT_RUNNING"):
            break
    g = p.guardians[j]
    g.crash()
    p.clock.call_later(2.0, g.restart)
    assert p.run_until_terminal([j], max_sim_s=3000)
    assert c.status(j) == ns.JobStatus.COMPLETED and p.cluster.used_chips == 0
    assert p.events.count("rollback") >= 1


def sc_learner_crash(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, sim_duration=300))
    until_processing(ns, p, j, 100)
    p.run_for(100)
    g = p.guardians[j]
    g.runtimes[0].kill()
    p.cluster.fail_pod(g.pods[0].name)
    assert p.run_until_terminal([j], max_sim_s=5000)
    assert c.status(j) == ns.JobStatus.COMPLETED
    assert "RESUMED" in [s[1] for s in c.status_history(j)] and p.meta.get(j).restarts == 1


def sc_node_failure(t, ns, tmp_path):
    p = t.platform(n_hosts=4, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, sim_duration=600))
    until_processing(ns, p, j, 100)
    host = p.guardians[j].pods[0].host
    p.cluster.fail_host(host)
    assert p.run_until_terminal([j], max_sim_s=8000)
    assert c.status(j) == ns.JobStatus.COMPLETED
    assert p.events.count("pod_evicted") >= 1 and p.events.count("node_notready") == 1
    t.notes.append(host)


def sc_halt_resume(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, sim_duration=400))
    until_processing(ns, p, j, 100)
    p.run_for(150)
    c.halt(j)
    p.run_for(30)
    assert c.status(j) == ns.JobStatus.HALTED and p.cluster.used_chips == 0
    c.resume(j)
    assert p.run_until_terminal([j], max_sim_s=5000)
    assert c.status(j) == ns.JobStatus.COMPLETED


def sc_quota_and_oversize(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    p.admission.register_tenant("small", quota_chips=2)
    c = t.client(p, tenant="small")
    c.submit(sim_job(ns, tenant="small", n_learners=1, chips_per_learner=2))
    c.submit(sim_job(ns, tenant="small", n_learners=2, chips_per_learner=2))
    p.run_for(120)
    with pytest.raises(ns.ApiError) as ei:
        c.submit(sim_job(ns, tenant="small", n_learners=2, chips_per_learner=4))
    assert ei.value.code == ns.ErrorCode.QUOTA_EXCEEDED
    with pytest.raises(ns.ApiError) as ei:
        t.client(p).submit(sim_job(ns, n_learners=4, chips_per_learner=4))  # 16 > 8
    assert ei.value.code == ns.ErrorCode.INVALID_ARGUMENT
    with pytest.raises(ns.ApiError) as ei:
        t.client(p, tenant="other").halt("job-00001")  # another tenant's job
    assert ei.value.code in (ns.ErrorCode.NOT_FOUND, ns.ErrorCode.FORBIDDEN)


def sc_logs_and_search(t, ns, tmp_path):
    p = t.platform(n_hosts=2, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, n_learners=1, chips_per_learner=1, sim_duration=300))
    assert p.run_until_terminal([j], max_sim_s=4000)
    assert c.status(j) == ns.JobStatus.COMPLETED
    lines = c.logs(j)
    assert any("checkpointed" in str(line) for line in lines)
    t.notes.append(lines)
    t.notes.append(c.search_logs("checkpointed"))
    t.notes.append(c.list_jobs())
    t.notes.append(c.usage())
    t.notes.append(c.events())


def sc_tenant_isolation(t, ns, tmp_path):
    p = t.platform(n_hosts=4, chips_per_host=4)
    c = t.client(p)
    a = c.submit(sim_job(ns, name="a", tenant="A"))
    b = c.submit(sim_job(ns, name="b", tenant="B"))
    assert p.run_until_terminal([a, b], max_sim_s=4000)
    assert [r["job_id"] for r in p.meta.history("A")] == [a]
    assert [r["job_id"] for r in p.meta.history("B")] == [b]
    ca = t.client(p, tenant="A")
    with pytest.raises(ns.ApiError):
        ca.status(b)  # another tenant's job
    t.notes.append(ca.list_jobs())
    t.notes.append([p.meta.history("A"), p.meta.history("B")])


def sc_straggler(t, ns, tmp_path):
    p = t.platform(n_hosts=4, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, sim_duration=240, straggler_timeout_s=60, max_restarts=5))
    until_processing(ns, p, j, 200)
    p.guardians[j].runtimes[1].stall()
    assert p.run_until_terminal([j], max_sim_s=8000)
    assert c.status(j) == ns.JobStatus.COMPLETED
    assert p.events.count("straggler_restart") >= 1


def sc_no_straggler_false_positive(t, ns, tmp_path):
    p = t.platform(n_hosts=4, chips_per_host=4)
    c = t.client(p)
    j = c.submit(sim_job(ns, sim_duration=120, straggler_timeout_s=60))
    until_processing(ns, p, j, 200)
    for rt in p.guardians[j].runtimes.values():
        rt.slowdown = 10.0
    assert p.run_until_terminal([j], max_sim_s=10000)
    assert c.status(j) == ns.JobStatus.COMPLETED
    assert p.events.count("straggler_restart") == 0


# --------------------------------------------------------------------------
# scenarios: tests/test_system.py
# --------------------------------------------------------------------------

def sc_mixed_workload_under_chaos(t, ns, tmp_path):
    """The reference's mixed workload with its real job replaced by a
    simulated one of the same shape: its JAX learner is not the port's."""
    chaos = ns.ChaosConfig(seed=11, p_learner_crash=0.002, p_host_fail=0.0005,
                           p_guardian_crash=0.001, p_controller_crash=0.002,
                           host_recovery_s=60.0)
    p = t.platform(n_hosts=8, chips_per_host=4, chaos=chaos, seed=1)
    c = t.client(p)
    p.admission.register_tenant("research", quota_chips=24)
    p.admission.register_tenant("prod", quota_chips=8)
    jobs = [c.submit(ns.JobManifest(name=f"sim{i}", tenant="research", n_learners=2,
                                    chips_per_learner=2, sim_duration=200, max_restarts=10))
            for i in range(6)]
    jobs.append(c.submit(ns.JobManifest(name="real", tenant="prod", n_learners=1,
                                        chips_per_learner=2, checkpoint_interval=20,
                                        max_restarts=10, sim_duration=300)))
    assert p.run_until_terminal(jobs, max_sim_s=30000)
    assert all(c.status(j) == ns.JobStatus.COMPLETED for j in jobs)
    assert p.cluster.used_chips == 0
    for j in jobs:
        hist = [s[1] for s in c.status_history(j)]
        assert hist[0] == "PENDING" and hist[-1] == "COMPLETED"
    assert (p.events.count("learner_killed") + p.events.count("host_killed")
            + p.events.count("guardian_crashed")) > 0


# --------------------------------------------------------------------------
# scenarios: tests/test_scheduler.py (gang and BSA placements)
# --------------------------------------------------------------------------

def sc_bsa_grid(t, ns, tmp_path):
    """BSA's placements over a grid of the reference's property test's
    parameters, each checked for capacity and all-or-nothing."""
    import numpy as np
    for n_hosts, chips, n_pods, cpp, policy, seed in [
            (1, 1, 1, 1, "pack", 0), (3, 2, 4, 1, "spread", 1), (6, 4, 5, 2, "pack", 2),
            (12, 8, 12, 3, "spread", 3), (24, 4, 7, 4, "pack", 4), (5, 8, 9, 8, "spread", 5),
            (24, 8, 12, 5, "pack", 0), (2, 2, 6, 1, "pack", 1)]:
        _, _, cluster = t.cluster(n_hosts, chips)
        out = ns.bsa_place(cluster.schedulable_hosts(), n_pods, cpp, policy=policy,
                           torus=cluster.torus, rng=np.random.default_rng(seed))
        feasible = cpp <= chips and (chips // cpp) * n_hosts >= n_pods
        assert (out is not None) == feasible
        t.notes.append(out)


def sc_bsa_pack_beats_spread(t, ns, tmp_path):
    import numpy as np
    for policy in ("spread", "pack"):
        _, _, cluster = t.cluster(4, 4)
        for j in range(4):
            out = ns.bsa_place(cluster.schedulable_hosts(), 1, 1, policy=policy,
                               torus=cluster.torus, rng=np.random.default_rng(j))
            assert cluster.bind_pod(ns.Pod(name=f"p{policy}{j}", job_id=f"j{j}",
                                           kind="learner", chips=1), out[0])
        frees = sorted(h.free_chips for h in cluster.hosts.values())
        assert (frees[-1] == 4) == (policy == "pack")


def sc_gang_all_or_nothing(t, ns, tmp_path):
    _, events, cluster = t.cluster(15, 4)
    sched = t.scheduler("GangScheduler", cluster, events, placement="pack")
    for i in range(50):
        sched.submit(ns.GangRequest(f"j{i}", 2, 2, submitted_at=0.0))
    sched.tick()
    assert len(t.placed) == 15 and sched.queue_depth() == 35


def sc_gang_order_cache_and_release(t, ns, tmp_path):
    _, events, cluster = t.cluster(4, 4)
    sched = t.scheduler("GangScheduler", cluster, events)
    sched.submit(ns.GangRequest("small", 1, 1, submitted_at=5.0))
    sched.submit(ns.GangRequest("big", 2, 4, submitted_at=5.0))
    sched.tick()
    assert t.placed[0][0] == "big"
    _, events, cluster = t.cluster(2, 4)
    sched = t.scheduler("GangScheduler", cluster, events)
    sched.submit(ns.GangRequest("a", 2, 4, submitted_at=0.0))
    sched.submit(ns.GangRequest("b", 2, 4, submitted_at=1.0))
    for _ in range(20):
        sched.tick()
    assert sched.queue_depth() == 1 and sched.stats["bsa_cache_hits"] >= 19
    sched.release("a")
    sched.tick()
    assert sched.queue_depth() == 0
    t.notes.append(sched.stats)


def sc_gang_against_k8s_default(t, ns, tmp_path):
    deadlocks = []
    for seed in range(10):
        for kind in ("K8sDefaultScheduler", "GangScheduler"):
            _, events, cluster = t.cluster(4, 2)
            sched = t.scheduler(kind, cluster, events, seed=seed)
            for i in range(4):
                sched.submit(ns.GangRequest(f"j{i}", 2, 2, submitted_at=0.0))
            sched.tick()
            if kind == "K8sDefaultScheduler":
                deadlocks.append(sched.deadlocked_learners())
    assert sum(deadlocks) > 0
    t.notes.append(deadlocks)


def sc_gang_reservations(t, ns, tmp_path):
    for seed, jobs in [(0, [(2, 2), (1, 4), (3, 1), (4, 4), (2, 3)]),
                       (3, [(1, 1)] * 7 + [(4, 2), (2, 4), (3, 3)])]:
        _, events, cluster = t.cluster(6, 4)
        sched = t.scheduler("GangScheduler", cluster, events, seed=seed)
        for i, (n, c) in enumerate(jobs):
            sched.submit(ns.GangRequest(f"j{i}", n, c, submitted_at=float(i)))
            sched.tick()
            assert cluster.used_chips + sum(sched._reserved_chips.values()) \
                <= cluster.total_chips


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_lifecycle, sc_durable_before_ack, sc_journal_recovery, sc_guardian_rollback,
    sc_learner_crash, sc_node_failure, sc_halt_resume, sc_quota_and_oversize,
    sc_logs_and_search, sc_tenant_isolation, sc_straggler, sc_no_straggler_false_positive,
    sc_mixed_workload_under_chaos, sc_bsa_grid, sc_bsa_pack_beats_spread,
    sc_gang_all_or_nothing, sc_gang_order_cache_and_release, sc_gang_against_k8s_default,
    sc_gang_reservations)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_leaves_the_same_trace_on_both_platforms(name, tmp_path):
    traces = {}
    for label, ns in (("reference", REF), ("port", PORT)):
        t = Trace(ns)
        SCENARIOS[name](t, ns, tmp_path)
        traces[label] = t.observed()
    ref, port = traces["reference"], traces["port"]
    assert ref["binds"] or ref["notes"] or ref["placed"]  # the scenario left a trace
    for key in ("binds", "placed", "wire", "notes"):
        assert port[key] == ref[key], key
    assert len(port["sides"]) == len(ref["sides"])
    for i, (a, b) in enumerate(zip(ref["sides"], port["sides"])):
        for key in a:
            assert b[key] == a[key], (i, key)


def test_keys_are_numbered_one_lower_than_the_reference():
    """The first tenant key is the same on both platforms, id and string:
    each platform's workloads plane drew key-0001 for its operator at
    construction, so the tenant's is key-0002 on both (ROADMAP C.30)."""
    keys = []
    for ns in (REF, PORT):
        p = ns.FfDLPlatform(n_hosts=1, chips_per_host=1, **ns.platform_kw)
        key = ns.ApiClient.for_platform(p, "A").api_key
        keys.append((p.auth.authenticate(key).key_id, key))
    assert keys[0][0] == "key-0002"
    assert keys[1] == keys[0]


def test_make_learner_picks_by_manifest_and_passes_the_device():
    volume, clock = texecutor.JobVolume("j"), ttypes.SimClock()
    ctx = lambda manifest: texecutor.LearnerContext(  # noqa: E731
        job_id="j", learner_idx=0, manifest=manifest, volume=volume, clock=clock,
        events=ttypes.EventLog(clock), objstore=ObjectStore(), device="cpu")
    sim = texecutor.make_learner(ctx(ttypes.JobManifest(name="s")))
    real = texecutor.make_learner(ctx(ttypes.JobManifest(name="r", arch="smollm-360m")))
    assert isinstance(sim, texecutor.SimLearner)
    assert isinstance(real, texecutor.TorchLearner) and real.device == "cpu"


# --------------------------------------------------------------------------
# real jobs: the port's learner through the port's platform
# --------------------------------------------------------------------------

REAL = dict(name="det", arch="smollm-360m", n_learners=1, chips_per_learner=2,
            checkpoint_interval=20, train={"steps": 60, "batch": 4, "seq": 64, "seed": 3})


def run_real_job(ns, crash_at_step=None, **platform_kw):
    """The crash-resume job of tests/test_torch_learner.py on ``ns``'s
    platform: (final leaves, status history, trace of the platform)."""
    t = Trace(ns)
    p = ns.FfDLPlatform(n_hosts=2, chips_per_host=4, **platform_kw)
    t.spy_binds(p.cluster)
    t.platforms.append(p)
    c = t.client(p)
    j = c.submit(ns.JobManifest(**REAL))
    crashed = False
    for _ in range(3000):
        p.tick()
        rec = p.meta.get(j)
        if rec.status in (ns.JobStatus.COMPLETED, ns.JobStatus.FAILED):
            break
        if crash_at_step is not None and not crashed \
                and rec.status == ns.JobStatus.PROCESSING and rec.progress_step >= crash_at_step:
            g = p.guardians[j]
            g.runtimes[0].kill()
            p.cluster.fail_pod(g.pods[0].name)
            crashed = True
    assert c.status(j) == ns.JobStatus.COMPLETED
    assert crashed == (crash_at_step is not None)
    bucket = MountedBucket(p.objstore, "results")
    final = ckpt.latest_step(bucket, f"{j}/ckpt")
    leaves, meta = ckpt.restore(bucket, f"{j}/ckpt", final)
    assert final == 60 and meta == {"final": True}
    assert json.loads(bucket.read(f"{j}/model/DONE")) == {"steps": 60}
    return leaves, [s[1] for s in c.status_history(j)], t, p.meta.get(j).restarts



@pytest.fixture(scope="module")
def straight_job(one_thread):
    return run_real_job(PORT, device="cpu")


def assert_bit_equal(a, b):
    assert set(a) == set(b)
    for path in a:
        assert a[path].dtype == b[path].dtype and torch.equal(a[path], b[path]), path


def test_real_job_crash_resume_is_bit_equal(straight_job):
    """smollm-360m tiny on the CPU through the port's platform, killed at
    step 30 of 60: the guardian restarts it, it resumes from the step-20
    checkpoint and ends on the uninterrupted job's state bit for bit."""
    leaves_a, hist_a, _, restarts_a = straight_job
    leaves_b, hist_b, trace, restarts_b = run_real_job(PORT, crash_at_step=30, device="cpu")
    assert (restarts_a, restarts_b) == (0, 1) and "RESUMED" in hist_b
    kinds = [e[3] for e in trace.observed()["sides"][0]["events"]]
    assert kinds.count("resume_from_checkpoint") == 1
    for seq in (hist_a, hist_b):
        order = [seq.index(s) for s in ("PENDING", "DEPLOYING", "DOWNLOADING", "PROCESSING",
                                        "STORING", "COMPLETED")]
        assert order == sorted(order)
    assert_bit_equal(leaves_a, leaves_b)


def test_real_job_equals_the_reference_platform_run(straight_job, monkeypatch):
    """The same job through the reference's platform, its guardian building
    the port's learner (the monkeypatch of tests/test_torch_learner.py):
    the same final state bit for bit, and the same trace."""
    def make_learner(ctx):
        return texecutor.TorchLearner(ctx, device="cpu")

    monkeypatch.setattr(rguardian, "make_learner", make_learner)
    leaves_p, _, trace_p, _ = straight_job
    leaves_r, _, trace_r, _ = run_real_job(REF)
    assert_bit_equal(leaves_p, leaves_r)
    assert trace_p.observed() == trace_r.observed()


def test_real_job_without_a_card_fails_and_never_trains(monkeypatch):
    """A platform on its default device (the card) where there is none: the
    learner's build fails, the job ends FAILED with the learner's fatal
    log naming the missing card, and no step ran on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the path taken where no card is present")
    learners = []

    def spy(ctx):
        learners.append(texecutor.make_learner(ctx))
        return learners[-1]

    monkeypatch.setattr(tguardian, "make_learner", spy)
    p = tcore.FfDLPlatform(n_hosts=2, chips_per_host=4)
    assert p.device is None
    c = tapi.ApiClient.for_platform(p)
    j = c.submit(tcore.JobManifest(**REAL))
    assert p.run_until_terminal([j], max_sim_s=2000)
    assert c.status(j) == tcore.JobStatus.FAILED
    logs = "\n".join(str(line) for line in c.logs(j))
    assert "fatal: repro_torch runs on a CUDA card by default and none is available" in logs
    assert learners and all(isinstance(lr, texecutor.TorchLearner) and lr.step == 0
                            and not lr.loss_history for lr in learners)
    assert not p.objstore.list("results")


def reference_init(cfg, seed, device="cpu"):
    """The reference's ``init_train_state`` of the port's config and seed,
    as a port train state."""
    jcfg = rbase.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    state = jsteps.init_train_state(jcfg, jax.random.key(seed))
    return train_state_from_numpy({p: np.asarray(x) for p, x in jflatten(state)}, cfg, device)


def run_fp32_job(ns, guardian_module, monkeypatch):
    """chip_smoke.FP32_JOB (recurrentgemma-2b, tiny, fp32, head_dim 256, 20
    steps, a checkpoint at step 10) through ``ns``'s platform and its own
    learner: (status, status history, the learner's per-tick losses, the
    final checkpoint's step)."""
    learners = []
    make = guardian_module.make_learner

    def spy(ctx):
        learners.append(make(ctx))
        return learners[-1]

    monkeypatch.setattr(guardian_module, "make_learner", spy)
    p = ns.FfDLPlatform(n_hosts=2, chips_per_host=4, **ns.platform_kw)
    c = ns.ApiClient.for_platform(p)
    j = c.submit(ns.JobManifest(name="fp32", arch="recurrentgemma-2b", n_learners=1,
                                chips_per_learner=2,
                                checkpoint_interval=chip_smoke.FP32_JOB_CKPT,
                                train=chip_smoke.FP32_JOB))
    assert p.run_until_terminal([j], max_sim_s=5000)
    (learner,) = learners
    return (c.status(j), [s[1] for s in c.status_history(j)], learner.loss_history,
            learner.step)


def test_fp32_head_dim_256_job_holds_to_the_reference_platform(one_thread, monkeypatch):
    """The fp32 job at head_dim 256 (the manifest phase 8 of chip_smoke.py
    runs on the card) on the CPU: the reference's platform with the
    reference's learner (JAX) and the port's with ``TorchLearner``, both
    from the reference's initial weights (the port's init draws other
    numbers): both COMPLETED after 20 steps with equal status histories,
    their per-tick losses at the same steps and within 1e-5 (relative)."""
    monkeypatch.setattr(tsteps, "init_train_state", reference_init)
    ref_status, ref_hist, ref_losses, ref_step = run_fp32_job(REF, rguardian, monkeypatch)
    status, hist, losses, step = run_fp32_job(PORT, tguardian, monkeypatch)
    assert ref_status == rcore.JobStatus.COMPLETED and status == tcore.JobStatus.COMPLETED
    assert ref_step == step == chip_smoke.FP32_JOB["steps"]
    assert hist == ref_hist and "STORING" in hist
    assert [s for s, _ in losses] == [s for s, _ in ref_losses] == [4, 9, 14, 19]
    for (_, got), (_, want) in zip(losses, ref_losses):
        assert abs(got - want) <= 1e-5 * abs(want), (losses, ref_losses)
