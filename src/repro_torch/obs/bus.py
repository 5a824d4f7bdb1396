"""The per-shard platform event bus (FfDL §4's audit/event trail).

Promoted from the original ``core.types.EventLog`` (an unbounded
in-process list) into a first-class observability primitive:

  * every event carries a **monotonic sequence number** — per shard,
    starting at 1, never reused for the life of the process — so a wire
    cursor (``seq``) identifies a position in the stream exactly once;
  * retention is a **bounded ring**: at least the most recent
    ``retention`` events are kept; older ones are dropped in batches
    (amortised O(1) per emit) and every drop is explicit —
    ``dropped_total`` counts them and a cursor reader is told how many
    events in its range were lost (``missed``), never silently skipped;
  * events are stamped with the owning **tenant** where one can be
    resolved (an explicit ``tenant=`` field, else the ``job=`` field
    through ``tenant_resolver``), which is what makes tenant-scoped
    visibility on ``GET /v2/events`` possible: a tenant key sees only
    events stamped with its own tenant, an admin key sees everything;
  * ``subscribe()`` lets in-process taps (the usage meter) observe every
    emit without polling.

Compatibility: ``EventLog(clock)`` construction still works (retention
and shard id default), ``emit``/``of_kind`` keep their shapes, and
``count(kind)`` stays exact for the **whole lifetime** of the bus — a
per-kind counter survives ring compaction, so a test that counts
``job_failed`` over a long campaign is unaffected by retention.
``of_kind``/``events`` expose the *retained* window only.

Emits and reads take a small internal mutex: emit sites run under shard
write locks, but the rate limiter emits ``rate_limited`` from HTTP
handler threads without any shard lock, and ``/v2/events`` reads under
the shard read lock — the bus must be safe under that mix.
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

# Default retained-window size. Large enough that every existing test and
# benchmark consumer sees the same counts it saw when the log was
# unbounded; campaigns that mine the full history (benchmarks/failures.py)
# pass an explicit larger retention.
DEFAULT_RETENTION = 1_000_000

# The pinned wire vocabulary: event kinds operators (and the operator
# loop) may key automation on, mapped to their emit sites in
# docs/architecture.md ("Observability plane") and checked by
# tests/test_docs_api.py. This list is COMPLETE by construction: the
# REG-EVENT analyzer (python -m repro.analysis) fails the build if any
# component emits a literal kind that is not registered here — an
# operator keying automation on /v2/events can trust the vocabulary.
PLATFORM_EVENT_KINDS = (
    # job lifecycle (guardian / api)
    "job_submitted", "submit_deduplicated", "admission_rejected",
    "job_completed", "job_failed", "job_halted",
    # scheduler / admission
    "gang_queued", "gang_placed", "no_nodes_available",
    "over_quota_admit", "preempt",
    # cluster / chaos
    "node_cordoned", "node_notready", "pod_evicted",
    "learner_killed", "host_killed", "controller_killed",
    # control plane
    "migration_phase", "lb_failover", "replica_crashed", "api_restarted",
    # backpressure (emitted by the rate limiter, no shard lock held)
    "rate_limited",
    # autonomous operator (repro.obs.operator: every reconciler action is
    # journaled so the decision log is auditable from /v2/events too)
    "operator_scale_up", "operator_scale_down", "operator_isolate_tenant",
    "operator_rollout_wave", "operator_rollout_done",
    "operator_rollout_halted", "operator_rollback",
    "operator_gray_restart",
    # gray-failure resilience (repro_torch.core.faults defenses): a shard tick
    # that outlived its deadline budget (Federation.tick records the
    # overrun on the shard's breaker and keeps the fleet ticking)
    "shard_tick_deadline",
    # declarative workloads (repro.workloads: plane apply/delete plus
    # every reconciler act — pipelines, recurring jobs, serving tier)
    "workload_applied", "workload_deleted",
    "workload_stage_submitted", "workload_stage_failed",
    "workload_pipeline_done", "workload_pipeline_degraded",
    "workload_recurring_run", "workload_recurring_skipped",
    "workload_service_scaled", "workload_service_ready",
    "workload_service_degraded",
    # pod/node lifecycle (repro_torch.core.cluster): the Kubernetes-shaped
    # bind/run/delete trail every gang leaves behind
    "pod_bound", "pod_running", "pod_deleted", "pod_failed",
    "pod_restarted", "binding_rejected", "node_ready",
    # guardian recovery ladder (repro_torch.core.guardian): per-job Helm-style
    # deployer decisions — restarts, rollbacks, gang requeues
    "guardian_crashed", "guardian_restarted", "guardian_created",
    "lcm_restarted", "rollback", "learner_restart", "learners_replaced",
    "straggler_restart", "gang_requeue", "bind_failed",
    "volume_provision_failed",
    # learner checkpointing (repro_torch.core.executor)
    "checkpoint", "resume_from_checkpoint",
    # controller status relay (repro_torch.core.controller)
    "status_relay_error",
)


@dataclass
class Event:
    ts: float
    component: str
    kind: str
    fields: dict
    # bus-assigned: position in the shard's stream (1-based, monotonic)
    seq: int = 0
    # owning tenant where resolvable; None = platform-internal (admin-only
    # visibility on the wire)
    tenant: Optional[str] = None


class EventBus:
    def __init__(self, clock, retention: int = DEFAULT_RETENTION,
                 shard_id: str = "shard-0"):
        if retention < 1:
            raise ValueError("retention must be >= 1")
        self.clock = clock
        self.retention = retention
        self.shard_id = shard_id
        self.dropped_total = 0
        # job_id -> tenant (or None); installed by the owning platform so
        # events carrying a job= field get stamped with their tenant
        self.tenant_resolver: Optional[Callable[[str], Optional[str]]] = None
        self._events: list[Event] = []  # retained window, oldest..newest
        self._first_seq = 1             # seq of _events[0]
        self._next_seq = 1
        # Drop in batches: del list[:k] is O(window), so a batch of
        # retention/16 keeps compaction amortised O(1) per emit. The
        # window briefly holds up to retention+batch-1 events (never
        # fewer than retention — the ring over-delivers, never under).
        self._batch = max(1, retention // 16)
        self._kind_counts: Counter = Counter()  # exact for all time
        self._subs: list[Callable[[Event], None]] = []
        self._lock = threading.Lock()

    # -- write side --------------------------------------------------------
    def emit(self, component: str, kind: str, **fields) -> Event:
        tenant = fields.get("tenant")
        if tenant is None and self.tenant_resolver is not None:
            job = fields.get("job")
            if job is not None:
                try:
                    tenant = self.tenant_resolver(job)
                except Exception:
                    tenant = None  # metastore down mid-emit: stay unstamped
        with self._lock:
            e = Event(self.clock.now(), component, kind, fields,
                      seq=self._next_seq, tenant=tenant)
            self._next_seq += 1
            self._events.append(e)
            self._kind_counts[kind] += 1
            if len(self._events) >= self.retention + self._batch:
                n = len(self._events) - self.retention
                del self._events[:n]
                self._first_seq += n
                self.dropped_total += n
            subs = list(self._subs)
        for fn in subs:  # outside the lock: a tap must not block emitters
            try:
                fn(e)
            except Exception:
                pass  # a broken tap must never take the platform down
        return e

    def subscribe(self, fn: Callable[[Event], None]):
        with self._lock:
            self._subs.append(fn)

    # -- read side ---------------------------------------------------------
    @property
    def events(self) -> list:
        """The retained window (oldest..newest). Compatibility surface —
        prefer ``since``/``read_since`` for anything cursor-shaped."""
        return self._events

    @property
    def seq(self) -> int:
        """High-water mark: seq of the newest event (0 when none yet)."""
        return self._next_seq - 1

    @property
    def first_seq(self) -> int:
        """Seq of the oldest retained event (``dropped_total + 1``)."""
        return self._first_seq

    def of_kind(self, kind: str) -> list:
        with self._lock:
            return [e for e in self._events if e.kind == kind]

    def count(self, kind: str) -> int:
        """Exact all-time count — survives ring compaction."""
        with self._lock:
            return self._kind_counts[kind]

    def since(self, seq: int) -> list:
        """Retained events with ``seq > seq`` (benchmark capture marks)."""
        with self._lock:
            idx = max(0, seq + 1 - self._first_seq)
            return self._events[idx:]

    def read_since(self, cursor: int, limit: int,
                   visible: Optional[Callable[[Event], bool]] = None,
                   kind: Optional[str] = None
                   ) -> tuple[list, int, int]:
        """One cursor page: up to ``limit`` events with ``seq > cursor``
        that pass the ``visible``/``kind`` filters.

        Returns ``(events, next_cursor, missed)``. ``next_cursor`` is the
        seq of the last event *scanned* (not just served): filtered-out
        events are consumed by the walk, and a scan that drains the bus
        jumps to the high-water mark so the next poll starts fresh. A
        served seq is therefore never served again on the same cursor
        chain — the exactly-once half of the contract; ``missed`` is the
        explicit other half: how many events in ``(cursor, first_seq)``
        retention already dropped before this read."""
        with self._lock:
            start = cursor + 1
            missed = max(0, min(self._first_seq, self._next_seq) - start)
            idx = max(0, start - self._first_seq)
            out: list[Event] = []
            last = max(cursor, self._first_seq - 1)
            for e in self._events[idx:]:
                last = e.seq
                if kind is not None and e.kind != kind:
                    continue
                if visible is not None and not visible(e):
                    continue
                out.append(e)
                if len(out) >= limit:
                    break
            return out, max(cursor, last), missed


def event_to_wire(e: Event, shard_id: str) -> dict:
    """The pinned /v2/events item shape."""
    return {"seq": e.seq, "ts": e.ts, "shard": shard_id,
            "component": e.component, "kind": e.kind,
            "tenant": e.tenant, "fields": dict(e.fields)}
