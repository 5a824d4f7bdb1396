"""Job scheduling (FfDL §3.4–3.6).

Two schedulers over the same ClusterModel:

* ``GangScheduler`` — the paper's production scheduler: FCFS with
  largest-gang-first tie-break, **all-or-nothing gang reservation** via BSA,
  PACK (default) or SPREAD placement, no overcommit. Guarantees zero
  temporary deadlocks (§3.5 / Fig 4). Reservations hold capacity from the
  moment of placement until the Guardian either confirms (pods bound) or
  releases (rollback/terminal) — there is never a window where two gangs
  can double-book chips.

* ``K8sDefaultScheduler`` — the baseline the paper measured against: each
  pod scheduled individually (spread-ranked), so a gang can be *partially*
  placed, holding chips while siblings queue — the temporary-deadlock
  pathology reproduced by benchmarks/gang.py.
"""

from __future__ import annotations

from bisect import insort
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.bsa import bsa_place
from repro_torch.core.cluster import ClusterModel
from repro_torch.core.types import EventLog, Pod


@dataclass
class GangRequest:
    job_id: str
    n_pods: int
    chips_per_pod: int
    submitted_at: float
    placement: Optional[list] = None  # host_id per pod, set when placed

    @property
    def total_chips(self) -> int:
        return self.n_pods * self.chips_per_pod


@dataclass
class _HostView:
    """Host with reservation-adjusted free capacity (what BSA sees)."""
    host_id: str
    n_chips: int
    coord: tuple
    free_chips: int
    schedulable: bool = True


class GangScheduler:
    """FCFS + gang + BSA + PACK/SPREAD."""

    def __init__(self, cluster: ClusterModel, events: EventLog,
                 placement: str = "pack", strict_fcfs: bool = False,
                 bsa_samples: int = 8, seed: int = 0):
        self.cluster = cluster
        self.events = events
        self.placement = placement
        self.strict_fcfs = strict_fcfs
        self.bsa_samples = bsa_samples
        self.rng = np.random.default_rng(seed)
        self.queue: list[GangRequest] = []
        # chips held by placed-but-not-yet-bound gangs
        self._reserved: dict[str, list] = {}      # job_id → host id per pod
        self._reserved_chips: Counter = Counter()  # host_id → chips
        self._chips_per_pod: dict[str, int] = {}
        self.on_placed: Optional[Callable[[GangRequest], None]] = None
        # BSA verdict cache: a gang that did not fit cannot fit again until
        # the cluster (free chips / schedulability) or this scheduler's
        # reservations change. "Does not fit" is deterministic in that
        # state (bsa_place returns None iff sum(free//cpp) < n_pods, before
        # consuming any randomness), so skipping the re-run is observably
        # identical — placements and the rng stream are unchanged.
        self._res_epoch = 0                 # bumped on reserve/confirm/release
        self._nofit: dict[str, tuple] = {}  # job_id → epoch pair at failure
        self.stats = {"bsa_runs": 0, "bsa_cache_hits": 0}

    # -- API ----------------------------------------------------------------
    def submit(self, req: GangRequest):
        # FCFS; same-instant arrivals resolved largest-gang-first (§3.6).
        # One bisect insertion keeps the queue sorted (ties land after
        # existing equals — exactly the old stable re-sort's order).
        insort(self.queue, req,
               key=lambda r: (r.submitted_at, -r.total_chips))
        self.events.emit("scheduler", "gang_queued", job=req.job_id,
                         chips=req.total_chips)

    def confirm(self, job_id: str):
        """Guardian bound the pods; chips are now held by the pods."""
        hosts = self._reserved.pop(job_id, None)
        if hosts:
            cpp = self._chips_per_pod.pop(job_id, 0)
            for h in hosts:
                self._reserved_chips[h] -= cpp
            self._res_epoch += 1

    def release(self, job_id: str):
        """Free a gang (finished/failed/preempted/rolled back)."""
        self.confirm(job_id)  # drop any unconfirmed reservation
        self.queue = [r for r in self.queue if r.job_id != job_id]
        self._nofit.pop(job_id, None)

    def queue_depth(self) -> int:
        return len(self.queue)

    def _host_views(self) -> list[_HostView]:
        # schedulable_hosts() is cached by the cluster and free_chips is an
        # O(1) counter, so building BSA's reservation-adjusted view is one
        # cheap pass — not a per-pod rescan of every pod on every host.
        return [
            _HostView(h.host_id, h.n_chips, h.coord,
                      h.free_chips - self._reserved_chips.get(h.host_id, 0))
            for h in self.cluster.schedulable_hosts()
        ]

    # -- scheduling round -------------------------------------------------
    def tick(self):
        progress = True
        while progress and self.queue:
            progress = False
            for req in list(self.queue):
                epoch = (self.cluster.epoch, self._res_epoch)
                if self._nofit.get(req.job_id) == epoch:
                    # nothing a placement can observe changed since this
                    # gang last failed to fit: the verdict stands, skip the
                    # BSA re-run (and the repeat no-nodes event)
                    self.stats["bsa_cache_hits"] += 1
                    if self.strict_fcfs:
                        return  # head-of-line still blocks
                    continue
                self.stats["bsa_runs"] += 1
                assignment = bsa_place(
                    self._host_views(), req.n_pods, req.chips_per_pod,
                    policy=self.placement, torus=self.cluster.torus,
                    samples=self.bsa_samples, rng=self.rng)
                if assignment is None:
                    self._nofit[req.job_id] = epoch
                    self.events.emit(
                        "scheduler", "no_nodes_available", job=req.job_id,
                        reason="no nodes match all predicates "
                               "(insufficient chips)")
                    if self.strict_fcfs:
                        return  # head-of-line blocks
                    continue
                # All-or-nothing reservation, atomic wrt this scheduler.
                self._nofit.pop(req.job_id, None)
                req.placement = assignment
                self._reserved[req.job_id] = assignment
                self._chips_per_pod[req.job_id] = req.chips_per_pod
                for h in assignment:
                    self._reserved_chips[h] += req.chips_per_pod
                self._res_epoch += 1
                self.queue.remove(req)
                self.events.emit("scheduler", "gang_placed", job=req.job_id,
                                 hosts=sorted(set(assignment)))
                if self.on_placed:
                    self.on_placed(req)
                progress = True
                break  # cluster state changed; re-walk the queue in order


class K8sDefaultScheduler:
    """Pod-at-a-time baseline (the §3.5 pathology).

    Binds each pod independently with the default spread ranking; a job's
    pods can land while its siblings starve, holding chips idle. Used by
    benchmarks/gang.py; the production platform uses GangScheduler.
    """

    def __init__(self, cluster: ClusterModel, events: EventLog,
                 placement: str = "spread", seed: int = 0):
        self.cluster = cluster
        self.events = events
        self.placement = placement
        self.rng = np.random.default_rng(seed)
        self.pod_queue: list[tuple[GangRequest, int]] = []
        self._assigned: dict[str, dict[int, str]] = {}
        self._reqs: dict[str, GangRequest] = {}
        self.on_placed: Optional[Callable[[GangRequest], None]] = None

    def submit(self, req: GangRequest):
        for k in range(req.n_pods):
            self.pod_queue.append((req, k))
        self._assigned.setdefault(req.job_id, {})
        self._reqs[req.job_id] = req
        # K8s processes pods roughly in arrival order with local
        # nondeterministic reordering (watch/queue races) — a full shuffle
        # would overstate the pathology vs the paper's Fig 4.
        jitter = self.rng.uniform(0, 8.0, size=len(self.pod_queue))
        order = sorted(range(len(self.pod_queue)),
                       key=lambda i: i + jitter[i])
        self.pod_queue = [self.pod_queue[i] for i in order]

    def release(self, job_id: str):
        self.pod_queue = [(r, k) for r, k in self.pod_queue
                          if r.job_id != job_id]
        for k, host in self._assigned.pop(job_id, {}).items():
            self.cluster.delete_pod(f"{job_id}-l{k}", reason="released")
        self._reqs.pop(job_id, None)

    def queue_depth(self) -> int:
        return len({r.job_id for r, _ in self.pod_queue})

    def deadlocked_learners(self) -> int:
        """Learners bound (holding chips) whose job is not fully bound —
        the paper's 'temporarily deadlocked' learners (Fig 4a)."""
        n = 0
        for job_id, req in self._reqs.items():
            done = len(self._assigned.get(job_id, {}))
            if 0 < done < req.n_pods:
                n += done
        return n

    def idle_chips(self) -> int:
        """Chips held by deadlocked learners (Fig 4b numerator)."""
        n = 0
        for job_id, req in self._reqs.items():
            done = len(self._assigned.get(job_id, {}))
            if 0 < done < req.n_pods:
                n += done * req.chips_per_pod
        return n

    def tick(self):
        # Placement is answered from the cluster's free-chips index: the
        # spread pick is min(same-job pods, -free, host id) and the pack
        # pick is min(free, host id) over eligible hosts — the same host
        # the old build-a-list-and-sort chose, without rescanning and
        # re-ranking every host for every queued pod on every tick.
        remaining = []
        for req, k in self.pod_queue:
            if self.placement == "spread":
                host = self.cluster.spread_host(req.chips_per_pod,
                                                req.job_id)
            else:
                host = self.cluster.pack_host(req.chips_per_pod)
            if host is None:
                self.events.emit("scheduler", "no_nodes_available",
                                 job=req.job_id, pod=k,
                                 reason="Insufficient chips")
                remaining.append((req, k))
                continue
            pod = Pod(name=f"{req.job_id}-l{k}", job_id=req.job_id,
                      kind="learner", chips=req.chips_per_pod)
            if not self.cluster.bind_pod(pod, host.host_id):
                remaining.append((req, k))
                continue
            self._assigned[req.job_id][k] = host.host_id
            if len(self._assigned[req.job_id]) == req.n_pods:
                req.placement = [self._assigned[req.job_id][i]
                                 for i in range(req.n_pods)]
                if self.on_placed:
                    self.on_placed(req)
        self.pod_queue = remaining
