"""Round-robin load balancer over stateless API replicas (FfDL §3.2).

The paper's recovery claim for the API tier: replicas are stateless, so a
crashed one is masked by routing to a healthy sibling — clients observe
zero failed calls as long as one replica is up. The Kubernetes Service in
front of FfDL's REST pods does exactly this; we reproduce it as a
client-side balancer so ``benchmarks/api_tier.py`` can measure it.

Routing: pure round-robin across replicas. A call that fails with a
*retryable* ``ApiError`` (``UNAVAILABLE`` — raised by a dead replica before
any side effect, so re-issuing is safe; ``submit`` dedup additionally rides
on idempotency keys) fails over to the next replica, trying each at most
once. Non-retryable errors (auth, validation, quota, not-found) propagate
immediately — they would fail identically everywhere.

Federation-aware: an ``UNAVAILABLE`` whose details carry ``shard_down``
means the caller's *backend shard* is dead, not the replica — every
replica routes the same tenant to the same shard, so failing over would
burn every replica to learn nothing. The balancer propagates it
immediately (and counts it in ``stats["shard_down"]``); tenants on other
shards are unaffected, and replica crash-masking still composes on top.

Gray failures compose the same way: ``DEADLINE_EXCEEDED`` (the verb
outlived its budget against a wedged-but-alive shard) is deliberately
NOT retryable — every replica fronts the same shard, so a failover
would burn another full deadline budget per replica to learn nothing.
It propagates immediately and is counted in
``stats["deadline_exceeded"]``; the per-shard circuit breaker (see
``repro_torch.core.faults``) then quarantines the shard so subsequent calls
get fast ``UNAVAILABLE`` (``shard_down`` + ``breaker_open`` details)
instead of each eating a budget.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.api.gateway import ApiGateway
from repro_torch.api.types import ApiError, ErrorCode


class LoadBalancer:
    def __init__(self, replicas: list, events=None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas: list[ApiGateway] = list(replicas)
        self.event_log = events  # the owning shard's bus (verb `events` differs)
        self._rr = 0
        # handler threads hit the balancer concurrently now that verbs
        # lock per shard instead of under one global HTTP lock — guard the
        # counters or the failover/shard_down numbers the benchmarks
        # report would undercount under exactly the loads they measure
        self._stats_lock = threading.Lock()
        self.stats = {"calls": 0, "failovers": 0, "exhausted": 0,
                      "shard_down": 0, "deadline_exceeded": 0}

    def _bump(self, key: str):
        with self._stats_lock:
            self.stats[key] += 1

    @property
    def healthy_replicas(self) -> list:
        return [r for r in self.replicas if r.alive]

    def _call(self, method: str, *args, **kwargs):
        self._bump("calls")
        n = len(self.replicas)
        last: Optional[ApiError] = None
        for _ in range(n):
            with self._stats_lock:
                replica = self.replicas[self._rr % n]
                self._rr += 1
            try:
                return getattr(replica, method)(*args, **kwargs)
            except ApiError as e:
                if e.code is ErrorCode.DEADLINE_EXCEEDED:
                    self._bump("deadline_exceeded")
                if not e.retryable:
                    raise
                if e.details.get("shard_down"):
                    # the tenant's shard is down, not this replica: every
                    # replica would answer identically — don't mask
                    self._bump("shard_down")
                    raise
                last = e
                self._bump("failovers")
                if self.event_log is not None:
                    self.event_log.emit("api", "lb_failover",
                                     replica=replica.replica_id,
                                     method=method)
        self._bump("exhausted")
        raise last if last is not None else ApiError(
            ErrorCode.UNAVAILABLE, "no replicas configured")

    # -- full v1 surface, delegated --------------------------------------
    def submit(self, api_key, req):
        return self._call("submit", api_key, req)

    def status(self, api_key, job_id, **kwargs):
        return self._call("status", api_key, job_id, **kwargs)

    def status_history(self, api_key, job_id):
        return self._call("status_history", api_key, job_id)

    def list_jobs(self, api_key, **kwargs):
        return self._call("list_jobs", api_key, **kwargs)

    def logs(self, api_key, job_id, **kwargs):
        return self._call("logs", api_key, job_id, **kwargs)

    def search_logs(self, api_key, query, **kwargs):
        return self._call("search_logs", api_key, query, **kwargs)

    def halt(self, api_key, job_id, requeue: bool = False):
        return self._call("halt", api_key, job_id, requeue=requeue)

    def resume(self, api_key, job_id):
        return self._call("resume", api_key, job_id)

    def cancel(self, api_key, job_id):
        return self._call("cancel", api_key, job_id)

    # -- observability plane ----------------------------------------------
    def usage(self, api_key, **kwargs):
        return self._call("usage", api_key, **kwargs)

    def events(self, api_key, **kwargs):
        return self._call("events", api_key, **kwargs)
