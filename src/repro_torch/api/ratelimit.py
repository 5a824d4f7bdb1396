"""Per-tenant backpressure for the API tier (FfDL §3.2, multi-tenant story).

The port's copy of the reference's ``repro/api/ratelimit.py``, unchanged.

The paper's API layer absorbs heavy traffic from many tenants at once; the
dependability claim only holds if one flooding tenant cannot starve the
others. Two mechanisms compose in front of the :class:`LoadBalancer`:

  * a **token bucket per tenant** — sustained rate ``rate`` req/s with a
    burst allowance of ``burst``. A drained bucket answers
    ``RATE_LIMITED`` (HTTP 429) with a ``retry_after`` hint instead of
    queueing, so a flood is rejected in O(1) without ever touching a
    gateway replica or the metastore;
  * a **bounded in-flight gate** — at most ``max_inflight`` requests may
    be inside the tier at once (across all tenants). Excess load sheds
    immediately rather than building an unbounded queue (tail-latency
    protection for everyone).

``RateLimitedApi`` wraps anything exposing the v1 verb surface (the
balancer, one gateway replica — of a single platform or a multi-shard
federation), so rate limiting composes with replica crash-masking AND
with per-shard locking: a throttled call is rejected before any shard
lock is even resolved, an admitted call still fails over on UNAVAILABLE.
One caveat worth knowing: a ``logs`` long-poll (``wait_ms``) occupies an
in-flight slot while it parks, so ``max_inflight`` bounds the number of
concurrently parked followers too.

Buckets are keyed by the *tenant* behind the API key (all of a tenant's
keys share one budget); unknown keys share a single "anonymous" bucket so
credential-guessing floods are throttled before auth even runs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from repro_torch.api.auth import ADMIN
from repro_torch.api.types import ApiError, ErrorCode

_ANON = "<anonymous>"


@dataclass(frozen=True)
class RateLimitConfig:
    """Per-tenant budget: ``rate`` tokens/s refill, ``burst`` capacity."""

    rate: float = 200.0
    burst: int = 100
    max_inflight: int = 64  # global gate (only read off the default config)


class TokenBucket:
    """Classic token bucket; thread-safe; injectable clock for tests."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> tuple[bool, float]:
        """Take ``n`` tokens if available. Returns ``(ok, retry_after)``;
        ``retry_after`` is how long until ``n`` tokens accrue (0 when ok).
        """
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        """Current balance including accrual since the last take."""
        with self._lock:
            return min(self.burst,
                       self._tokens + (self._clock() - self._last) * self.rate)


class RateLimitedApi:
    """The v1 verb surface with per-tenant admission in front.

    ``inner`` is any object with the nine v1 verbs (``LoadBalancer``,
    ``ApiGateway``, ...). ``auth`` resolves API keys to tenants for bucket
    selection (without consuming the authentication itself — the gateway
    still authenticates admitted calls).
    """

    def __init__(self, inner, auth,
                 config: Optional[RateLimitConfig] = None,
                 per_tenant: Optional[Dict[str, RateLimitConfig]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.auth = auth
        self.config = config or RateLimitConfig()
        self.per_tenant = dict(per_tenant or {})
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # counters are touched by every handler thread; guard them or the
        # shed/throttle numbers undercount under exactly the floods they
        # exist to measure
        self._stats_lock = threading.Lock()
        self.stats = {"admitted": 0, "throttled": 0, "shed_inflight": 0}
        self.throttled_by_tenant: Dict[str, int] = {}
        # observability hookup (attach_observability): throttles become
        # `rate_limited` platform events + per-tenant meter counts
        self._router = None

    def set_tenant_config(self, tenant: str, config: Optional[RateLimitConfig]):
        """Live-update one tenant's budget (v2 admin PATCH). ``None``
        reverts to the default config. The tenant's existing bucket is
        dropped so the new rate/burst apply to the very next request."""
        with self._buckets_lock:
            if config is None:
                self.per_tenant.pop(tenant, None)
            else:
                self.per_tenant[tenant] = config
            self._buckets.pop(tenant, None)

    # -- admission --------------------------------------------------------
    def _tenant_of(self, api_key: str) -> str:
        principal = self.auth.peek(api_key)
        return principal.tenant if principal is not None else _ANON

    def _bucket_for(self, tenant: str) -> TokenBucket:
        with self._buckets_lock:
            b = self._buckets.get(tenant)
            if b is None:
                cfg = self.per_tenant.get(tenant, self.config)
                b = TokenBucket(cfg.rate, cfg.burst, clock=self._clock)
                self._buckets[tenant] = b
        return b

    def _admit(self, api_key: str) -> str:
        tenant = self._tenant_of(api_key)
        ok, retry_after = self._bucket_for(tenant).try_take(1.0)
        if not ok:
            with self._stats_lock:
                self.stats["throttled"] += 1
                self.throttled_by_tenant[tenant] = \
                    self.throttled_by_tenant.get(tenant, 0) + 1
            self._note_throttle(tenant)
            raise ApiError(ErrorCode.RATE_LIMITED,
                           f"tenant {tenant!r} exceeded its request rate",
                           tenant=tenant, retry_after=round(retry_after, 4))
        return tenant

    def admit_once(self, api_key: str) -> str:
        """Spend ONE token for a long-lived SSE stream at open time. A
        stream then holds no in-flight slot and no further tokens — the
        server's own ``max_streams`` cap bounds concurrency instead."""
        return self._admit(api_key)

    # -- observability ----------------------------------------------------
    def attach_observability(self, router):
        """Give the limiter a TenantRouter so 429s become ``rate_limited``
        platform events on the throttled tenant's home shard (satellite:
        throttling must be operator-visible). No wire behavior change —
        the 429/Retry-After envelope is untouched."""
        self._router = router

    def _note_throttle(self, tenant: str):
        # Emitted WITHOUT any shard lock (handler thread) — the bus takes
        # its own mutex. Best-effort: anonymous floods have no home shard.
        if self._router is None or tenant == _ANON:
            return
        try:
            backend = self._router.shard_for(tenant)
            if backend.alive:
                backend.platform.events.emit("ratelimit", "rate_limited",
                                             tenant=tenant)
        except Exception:
            pass

    def _enter(self):
        with self._inflight_lock:
            if self._inflight >= self.config.max_inflight:
                with self._stats_lock:
                    self.stats["shed_inflight"] += 1
                raise ApiError(
                    ErrorCode.RATE_LIMITED,
                    f"API tier at max in-flight requests "
                    f"({self.config.max_inflight})",
                    retry_after=0.05)
            self._inflight += 1

    def _exit(self):
        with self._inflight_lock:
            self._inflight -= 1

    def throttle_non_admin(self, api_key: str):
        """Admission check for the v2 admin plane: operator keys (the
        ``admin``-scoped ``"*"`` principals) pass untouched — admin verbs
        are the operator's backpressure controls, not tenant traffic — but
        unknown keys, tenant keys, and wildcard keys WITHOUT the admin
        scope spend a token from their usual bucket, so a flood against
        ``/v2/admin`` is throttled before auth exactly like one against
        v1."""
        principal = self.auth.peek(api_key)
        if principal is not None and principal.is_admin \
                and principal.can(ADMIN):
            return
        self._admit(api_key)

    def _call(self, method: str, api_key: str, *args, **kwargs):
        # gate before bucket: a request shed at the in-flight limit (global
        # congestion the tenant didn't cause) must not also cost a token
        self._enter()
        try:
            self._admit(api_key)
            with self._stats_lock:
                self.stats["admitted"] += 1
            return getattr(self.inner, method)(api_key, *args, **kwargs)
        finally:
            self._exit()

    # -- full v1 surface, gated -------------------------------------------
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

    # -- observability plane, gated ---------------------------------------
    def usage(self, api_key, **kwargs):
        return self._call("usage", api_key, **kwargs)

    def events(self, api_key, **kwargs):
        return self._call("events", api_key, **kwargs)
