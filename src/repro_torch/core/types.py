"""Shared platform types: clock, events, job/pod model, statuses.

Status vocabulary is the paper's (§2: "DL-specific job statuses (e.g.,
DOWNLOADING, PROCESSING, STORING, HALTED, RESUMED)" + §3.3 FAILED/COMPLETED
+ the implicit QUEUED/DEPLOYING stages of the Guardian workflow).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Optional


# --------------------------------------------------------------------------
# Clock — simulated (deterministic benchmarks) or wall (examples)
# --------------------------------------------------------------------------

class SimClock:
    """Discrete-event clock. Components schedule callbacks; run() drains."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list = []
        self._counter = itertools.count()

    def now(self) -> float:
        return self._now

    def advance(self, dt: float):
        self._now += max(dt, 0.0)

    def call_at(self, t: float, fn: Callable[[], None]):
        heapq.heappush(self._heap, (max(t, self._now), next(self._counter), fn))

    def call_later(self, dt: float, fn: Callable[[], None]):
        self.call_at(self._now + dt, fn)

    def run_until(self, t_end: float):
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self._now = max(self._now, t)
            fn()
        self._now = max(self._now, t_end)

    def pending(self) -> int:
        return len(self._heap)


class WallClock:
    def __init__(self):
        import time
        self._time = time

    def now(self) -> float:
        return self._time.time()

    def advance(self, dt: float):
        if dt > 0:
            self._time.sleep(dt)


# --------------------------------------------------------------------------
# Structured event log (drives the §5.6 failure-analysis benchmark).
# Promoted into the observability plane's per-shard event bus: sequence
# numbers, bounded retention, tenant stamping, wire visibility via
# GET /v2/events. `EventLog` stays as the historical name — same emit /
# of_kind / count surface, now backed by repro_torch.obs.bus.EventBus.
# --------------------------------------------------------------------------

from repro_torch.obs.bus import Event, EventBus  # noqa: E402  (re-export)

EventLog = EventBus


# --------------------------------------------------------------------------
# Job / pod model
# --------------------------------------------------------------------------

class JobStatus(str, Enum):
    PENDING = "PENDING"          # accepted, metadata durable, not yet deployed
    QUEUED = "QUEUED"            # waiting for gang resources
    DEPLOYING = "DEPLOYING"      # guardian provisioning
    DOWNLOADING = "DOWNLOADING"  # load-data helper streaming the dataset
    PROCESSING = "PROCESSING"    # learners training
    STORING = "STORING"          # store-results helper uploading model
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    HALTED = "HALTED"            # user/AC-initiated checkpoint-and-stop
    RESUMED = "RESUMED"          # transitional status after HALT → requeue


TERMINAL = {JobStatus.COMPLETED, JobStatus.FAILED}


class PodPhase(str, Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"


# The pinned ``train:`` sub-spec vocabulary — exactly the keys the learner
# runtime consumes (core/executor.py). The v1 submit path rejects anything
# else with INVALID_ARGUMENT instead of silently ignoring it, so a typo in
# a manifest-derived spec ("step" for "steps") surfaces at submit time
# rather than as a job that trains with defaults. Pinned in docs/api.md.
TRAIN_SPEC_FIELDS = ("tiny", "overrides", "steps", "lr", "warmup",
                     "seq", "batch", "seed")


def unknown_spec_fields(m: "JobManifest") -> list:
    """Typo'd keys in the manifest's ``train`` sub-spec (sorted), or a
    one-element sentinel when ``train`` is not a mapping at all."""
    if not isinstance(m.train, dict):
        return ["train (must be a mapping)"]
    return sorted(set(m.train) - set(TRAIN_SPEC_FIELDS))


@dataclass
class JobManifest:
    """What the user submits — FfDL's 'natural language job description':
    code ref (here: arch/workload), data location, resources per learner."""

    name: str
    tenant: str = "default"
    n_learners: int = 1
    chips_per_learner: int = 1
    tier: str = "paid"  # paid | free (admission-control preemption class)
    # Real training workload (arch id + trainer overrides), or simulated:
    arch: Optional[str] = None
    train: dict = field(default_factory=dict)  # steps, batch, seq, ckpt_every
    sim_duration: Optional[float] = None       # simulated job runtime (s)
    data_bucket: str = "datasets"
    results_bucket: str = "results"
    checkpoint_interval: int = 50   # steps between checkpoints (real jobs)
    max_restarts: int = 3
    max_deploy_retries: int = 3
    # straggler mitigation: restart a learner whose progress stalls for this
    # many seconds while a peer advances (0 = disabled). Catches silent
    # stalls that exit-code monitoring cannot (degraded-but-alive nodes).
    straggler_timeout_s: float = 0.0


@dataclass
class Pod:
    name: str
    job_id: str
    kind: str  # learner | helper | guardian-proxy
    chips: int
    host: Optional[str] = None
    phase: PodPhase = PodPhase.PENDING
    restarts: int = 0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclass
class JobRecord:
    """Durable metadata (MongoDB analogue content)."""

    job_id: str
    manifest: JobManifest
    status: JobStatus = JobStatus.PENDING
    status_history: list = field(default_factory=list)  # [(ts, status, msg)]
    submitted_at: float = 0.0
    scheduled_at: Optional[float] = None
    finished_at: Optional[float] = None
    placement: Optional[dict] = None  # pod_name → host
    restarts: int = 0
    deploy_retries: int = 0
    progress_step: int = 0
    message: str = ""

    def set_status(self, ts: float, status: JobStatus, msg: str = ""):
        self.status = status
        self.message = msg
        self.status_history.append((ts, status.value, msg))


def gang_chips(m: JobManifest) -> int:
    return m.n_learners * m.chips_per_learner
