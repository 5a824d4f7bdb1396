"""ClusterModel: hosts with TPU chips, heartbeats, failures, pod lifecycle.

The port's copy of the reference's simulated cluster
(``repro/core/cluster.py``), kept as it is so that the same scenario gives
the same placements on both platforms. It is a model of the reference's
hosts and their torus, not of the machine the port trains on: ``chips``
and ``chips_per_host`` are the platform's abstract resources, and no figure
here describes a card.

The K8s/node layer of the platform (DESIGN.md §2 mapping):

  * Host = machine with ``chips_per_host`` TPU chips at coordinates (x, y) on
    the pod's 2D ICI torus (locality input for the BSA PACK bias — the TPU
    analogue of FfDL's "Spread increases communication cost" observation).
  * Heartbeat leases in the coordination store; a host whose lease lapses
    goes NotReady and the node controller **evicts** its pods (the paper's
    NodeControllerEviction behavior, §5.6).
  * Pods are granted exclusive chips (no overcommit, §3.6); stateful-set
    pods are restarted by the cluster after crash (§3.8), which is what
    makes learner recovery work without Guardian involvement.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.kvstore import EtcdLike
from repro_torch.core.types import EventLog, Pod, PodPhase


@dataclass
class Host:
    host_id: str
    n_chips: int
    coord: tuple  # (x, y) on the torus
    ready: bool = True
    cordoned: bool = False
    pods: dict = field(default_factory=dict)  # pod_name → Pod
    # incrementally maintained by ClusterModel on every pod phase
    # transition (chips held by PENDING/RUNNING pods) — what used to be
    # recomputed by summing every pod on every free_chips read
    used_chips: int = 0
    # pods present per job (any phase) — the spread ranking's same-job
    # count, maintained on bind/delete
    job_pods: dict = field(default_factory=dict)

    @property
    def free_chips(self) -> int:
        return self.n_chips - self.used_chips

    @property
    def schedulable(self) -> bool:
        return self.ready and not self.cordoned


def torus_distance(a: tuple, b: tuple, size: tuple) -> int:
    return sum(min(abs(ai - bi), si - abs(ai - bi))
               for ai, bi, si in zip(a, b, size))


class ClusterModel:
    HEARTBEAT_TTL = 15.0      # lease ttl (node NotReady after this lapses)
    HEARTBEAT_PERIOD = 5.0
    POD_START_LATENCY = {     # Table 3-calibrated start costs (seconds)
        "learner": 12.0,      # binding object store + volumes: 10-20s
        "helper": 3.0,
        "guardian": 1.5,
    }

    def __init__(self, n_hosts: int, chips_per_host: int, clock,
                 etcd: EtcdLike, events: EventLog, torus_width: int = 0):
        self.clock = clock
        self.etcd = etcd
        self.events = events
        w = torus_width or max(1, int(math.isqrt(n_hosts)))
        self.torus = (w, max(1, (n_hosts + w - 1) // w))
        self.hosts: dict[str, Host] = {}
        for i in range(n_hosts):
            hid = f"host-{i:04d}"
            self.hosts[hid] = Host(hid, chips_per_host,
                                   (i % w, i // w))
        self.pods: dict[str, Pod] = {}
        self._restart_hooks: list[Callable[[Pod], None]] = []
        self._eviction_hooks: list[Callable[[Pod, str], None]] = []
        self._heartbeat_leases: dict[str, int] = {}
        self._failed_heartbeat: set[str] = set()
        # -- free-chips index (scheduler hot path) -------------------------
        # Schedulable hosts bucketed by current free chips, kept in sync on
        # every pod phase transition and node health flip, so a placement
        # query ("smallest/largest free >= k") never rescans the cluster.
        self._free_buckets: dict[int, set[str]] = {}
        self._bucket_of: dict[str, int] = {}
        self._max_chips = chips_per_host
        self._sched_cache: Optional[list[Host]] = None
        # placement epoch: bumped whenever anything a placement decision
        # can observe changes (free chips, schedulability). GangScheduler
        # caches "gang does not fit" verdicts keyed on it.
        self.epoch = 0
        for hid in self.hosts:
            self._heartbeat_leases[hid] = etcd.grant_lease(self.HEARTBEAT_TTL)
            etcd.put(f"/nodes/{hid}", "Ready",
                     lease_id=self._heartbeat_leases[hid])
            self._reindex(self.hosts[hid])

    # -- capacity -----------------------------------------------------------
    @property
    def total_chips(self) -> int:
        return sum(h.n_chips for h in self.hosts.values())

    @property
    def used_chips(self) -> int:
        return sum(h.used_chips for h in self.hosts.values())

    def utilization(self) -> float:
        return self.used_chips / max(self.total_chips, 1)

    def schedulable_hosts(self) -> list[Host]:
        """Schedulable hosts in stable host order. Cached; invalidated
        only when a host's schedulability flips (rare), not on every
        placement query."""
        if self._sched_cache is None:
            self._sched_cache = [h for h in self.hosts.values()
                                 if h.schedulable]
        return self._sched_cache

    # -- free-chips index --------------------------------------------------
    def _reindex(self, host: Host):
        """Move ``host`` to the bucket for its current free capacity
        (schedulable hosts only)."""
        self.epoch += 1
        old = self._bucket_of.pop(host.host_id, None)
        if old is not None:
            self._free_buckets[old].discard(host.host_id)
        if host.schedulable:
            f = host.free_chips
            self._free_buckets.setdefault(f, set()).add(host.host_id)
            self._bucket_of[host.host_id] = f

    def _schedulable_flip(self, host: Host):
        self._sched_cache = None
        self._reindex(host)

    def _account(self, host: Host, delta: int):
        host.used_chips += delta
        self._reindex(host)

    def pack_host(self, min_free: int) -> Optional[Host]:
        """Best-fit: the schedulable host with the SMALLEST free capacity
        >= ``min_free`` (lowest host id on ties) — the pack ranking's
        ``sort(key=free)[0]``, answered from the buckets."""
        for f in range(min_free, self._max_chips + 1):
            bucket = self._free_buckets.get(f)
            if bucket:
                return self.hosts[min(bucket)]
        return None

    def spread_host(self, min_free: int, job_id: str) -> Optional[Host]:
        """The spread ranking's pick: minimal ``(same-job pods, -free,
        host id)`` over schedulable hosts with free >= ``min_free`` —
        identical to sorting every host, served from the buckets. Walks
        free levels descending; the first level holding a host with no
        same-job pods wins outright (no lower level can beat it)."""
        best = None  # (same_job, -free, host_id)
        for f in range(self._max_chips, min_free - 1, -1):
            bucket = self._free_buckets.get(f)
            if not bucket:
                continue
            zero_best = nz_best = None
            for hid in bucket:
                same = self.hosts[hid].job_pods.get(job_id, 0)
                if same == 0:
                    if zero_best is None or hid < zero_best:
                        zero_best = hid
                elif nz_best is None or (same, hid) < nz_best:
                    nz_best = (same, hid)
            if zero_best is not None:
                return self.hosts[zero_best]
            if nz_best is not None:
                cand = (nz_best[0], -f, nz_best[1])
                if best is None or cand < best:
                    best = cand
        return None if best is None else self.hosts[best[2]]

    # -- pod lifecycle -------------------------------------------------------
    def bind_pod(self, pod: Pod, host_id: str) -> bool:
        """Bind a pod to a host (exclusive chip grant). False if rejected."""
        host = self.hosts[host_id]
        if not host.schedulable or host.free_chips < pod.chips:
            self.events.emit("k8s", "binding_rejected", pod=pod.name,
                             host=host_id)
            return False
        pod.host = host_id
        pod.phase = PodPhase.PENDING
        host.pods[pod.name] = pod
        host.job_pods[pod.job_id] = host.job_pods.get(pod.job_id, 0) + 1
        self.pods[pod.name] = pod
        self._account(host, pod.chips)
        latency = self.POD_START_LATENCY.get(pod.kind, 3.0)
        self.clock.call_later(latency, lambda: self._start_pod(pod))
        self.events.emit("k8s", "pod_bound", pod=pod.name, host=host_id,
                         chips=pod.chips)
        return True

    def _start_pod(self, pod: Pod):
        if pod.phase == PodPhase.PENDING and pod.host is not None:
            pod.phase = PodPhase.RUNNING
            pod.started_at = self.clock.now()
            self.events.emit("k8s", "pod_running", pod=pod.name)

    def delete_pod(self, pod_name: str, reason: str = "deleted"):
        pod = self.pods.pop(pod_name, None)
        if pod is None:
            return
        holds_chips = pod.phase in (PodPhase.PENDING, PodPhase.RUNNING)
        if pod.host and pod.host in self.hosts:
            host = self.hosts[pod.host]
            if host.pods.pop(pod.name, None) is not None:
                n = host.job_pods.get(pod.job_id, 0) - 1
                if n > 0:
                    host.job_pods[pod.job_id] = n
                else:
                    host.job_pods.pop(pod.job_id, None)
                if holds_chips:
                    self._account(host, -pod.chips)
        pod.phase = PodPhase.DELETED
        pod.finished_at = self.clock.now()
        self.events.emit("k8s", "pod_deleted", pod=pod_name, reason=reason)

    def fail_pod(self, pod_name: str, reason: str = "crash"):
        """Pod process crash. Stateful-set pods get restarted in place."""
        pod = self.pods.get(pod_name)
        if pod is None or pod.phase != PodPhase.RUNNING:
            return
        pod.phase = PodPhase.FAILED
        if pod.host and pod.host in self.hosts:  # FAILED pods hold no chips
            self._account(self.hosts[pod.host], -pod.chips)
        self.events.emit("k8s", "pod_failed", pod=pod_name, reason=reason)

    def restart_pod(self, pod_name: str):
        """K8s stateful-set restart: same host, new container."""
        pod = self.pods.get(pod_name)
        if pod is None or pod.host is None:
            return
        pod.restarts += 1
        if pod.phase not in (PodPhase.PENDING, PodPhase.RUNNING) \
                and pod.host in self.hosts:
            self._account(self.hosts[pod.host], pod.chips)
        pod.phase = PodPhase.PENDING
        latency = self.POD_START_LATENCY.get(pod.kind, 3.0)
        self.clock.call_later(latency, lambda: self._start_pod(pod))
        self.events.emit("k8s", "pod_restarted", pod=pod_name,
                         restarts=pod.restarts)

    def complete_pod(self, pod_name: str):
        pod = self.pods.get(pod_name)
        if pod is not None:
            if pod.phase in (PodPhase.PENDING, PodPhase.RUNNING) \
                    and pod.host and pod.host in self.hosts:
                self._account(self.hosts[pod.host], -pod.chips)
            pod.phase = PodPhase.SUCCEEDED
            pod.finished_at = self.clock.now()

    def on_eviction(self, fn: Callable[[Pod, str], None]):
        self._eviction_hooks.append(fn)

    # -- node health -----------------------------------------------------
    def fail_host(self, host_id: str):
        """Chaos: host stops heartbeating (hardware fault / reboot)."""
        self._failed_heartbeat.add(host_id)

    def recover_host(self, host_id: str):
        self._failed_heartbeat.discard(host_id)
        host = self.hosts[host_id]
        if not host.ready:
            host.ready = True
            self._schedulable_flip(host)
            lease = self.etcd.grant_lease(self.HEARTBEAT_TTL)
            self._heartbeat_leases[host_id] = lease
            self.etcd.put(f"/nodes/{host_id}", "Ready", lease_id=lease)
            self.events.emit("node_controller", "node_ready", host=host_id)

    def cordon(self, host_id: str):
        host = self.hosts[host_id]
        host.cordoned = True
        self._schedulable_flip(host)
        self.events.emit("node_controller", "node_cordoned", host=host_id)

    def tick(self):
        """Heartbeats + NotReady detection + eviction. Call every few sim-s."""
        now = self.clock.now()
        for hid, host in self.hosts.items():
            if hid not in self._failed_heartbeat and host.ready:
                self.etcd.keepalive(self._heartbeat_leases[hid])
        self.etcd.sweep_leases()
        for hid, host in self.hosts.items():
            alive = self.etcd.get(f"/nodes/{hid}") is not None
            if host.ready and not alive:
                host.ready = False
                self._schedulable_flip(host)
                self.events.emit("node_controller", "node_notready", host=hid)
                self._evict_host_pods(hid)

    def _evict_host_pods(self, host_id: str):
        """NodeControllerEviction: delete all pods on a NotReady node."""
        host = self.hosts[host_id]
        for pod in list(host.pods.values()):
            self.events.emit("node_controller", "pod_evicted", pod=pod.name,
                             host=host_id, pod_kind=pod.kind)
            self.delete_pod(pod.name, reason="node_failure")
            for fn in self._eviction_hooks:
                fn(pod, "node_failure")
