"""v1 API contract: versioned request/response envelopes + structured errors.

FfDL's API tier (§3.2) is the platform's only public surface: every request
is validated, authenticated per tenant, and answered with a typed response.
This module is the wire contract for our reproduction of that tier:

  * every request/response envelope carries ``api_version`` (currently
    ``"v1"``); a gateway rejects versions it does not speak with a stable
    ``UNSUPPORTED_VERSION`` error instead of silently misparsing;
  * errors are ``ApiError`` with a stable :class:`ErrorCode` — clients (and
    the load balancer) branch on ``err.code``, never on exception class or
    message text;
  * list-shaped responses are ``Page`` envelopes with an opaque
    ``next_cursor`` — cursors stay stable under concurrent submits because
    they key on monotonically increasing ids/offsets, not list positions.

The same contract is served over two transports: in-process (the
``LoadBalancer`` / ``ApiGateway`` objects) and JSON-over-HTTP
(:mod:`repro.api.http`), where every ``ErrorCode`` maps to a stable HTTP
status (see ``repro.api.http.STATUS_OF`` and ``docs/api.md``).

The pre-gateway raw-exception facade (``ApiError.to_legacy()`` plus the
``FfDLPlatform.submit/status/...`` shims) was removed once every caller
migrated to tenant-scoped keys; clients now always see ``ApiError``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from enum import Enum
from typing import Generic, List, Optional, TypeVar

from repro_torch.core.types import JobManifest, JobRecord

API_VERSION = "v1"
SUPPORTED_VERSIONS = ("v1",)
# The v2 admin control plane (repro.api.admin) is a SEPARATE, versioned
# surface: resource-oriented operator envelopes stamped "v2". The v1 job
# data plane above is untouched by it — v1 requests still carry (and are
# answered with) "v1", and v1 rejects anything else exactly as before.
ADMIN_API_VERSION = "v2"

T = TypeVar("T")


class ErrorCode(str, Enum):
    UNAUTHENTICATED = "UNAUTHENTICATED"        # missing/unknown/revoked key
    FORBIDDEN = "FORBIDDEN"                    # authenticated, wrong tenant/scope
    NOT_FOUND = "NOT_FOUND"                    # unknown job id
    INVALID_ARGUMENT = "INVALID_ARGUMENT"      # malformed manifest/cursor
    QUOTA_EXCEEDED = "QUOTA_EXCEEDED"          # admission control rejection
    FAILED_PRECONDITION = "FAILED_PRECONDITION"  # e.g. resume on non-HALTED job
    CONFLICT = "CONFLICT"                      # idempotency key reused with a
    #                                            different payload
    UNAVAILABLE = "UNAVAILABLE"                # replica/metastore/shard down;
    #                                            retryable — except when
    #                                            details carry ``shard_down``
    #                                            (the tenant's backend shard
    #                                            is dead; every replica
    #                                            answers identically, so the
    #                                            LB propagates immediately)
    UNSUPPORTED_VERSION = "UNSUPPORTED_VERSION"
    RATE_LIMITED = "RATE_LIMITED"              # per-tenant backpressure (429);
    #                                            details carry ``retry_after``
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"    # request outlived its per-verb
    #                                            deadline budget (504). NOT
    #                                            LB-retryable: every replica
    #                                            fronts the same shard, so a
    #                                            wedged shard would just eat
    #                                            another full budget per
    #                                            replica. Idempotent verbs may
    #                                            be retried client-side with
    #                                            backoff (see ApiClient).


# Codes the load balancer may transparently retry on another replica.
# RATE_LIMITED is deliberately NOT here: it is raised by the admission
# front *before* the balancer, and failing over would defeat backpressure.
RETRYABLE = {ErrorCode.UNAVAILABLE}


class ApiError(Exception):
    """Structured API failure with a stable, client-branchable code."""

    def __init__(self, code: ErrorCode, message: str = "", **details):
        super().__init__(f"[{code.value}] {message}")
        self.code = code
        self.message = message
        self.details = details

    @property
    def retryable(self) -> bool:
        return self.code in RETRYABLE

    @property
    def retry_after(self) -> Optional[float]:
        """Seconds the client should wait before retrying (RATE_LIMITED)."""
        return self.details.get("retry_after")


# --------------------------------------------------------------------------
# Deadline guard (shared by every wire-facing gateway)
# --------------------------------------------------------------------------

def deadline_guarded(budget_s: float = 10.0, attr: str = "verb_budget_s"):
    """Decorator factory: run a gateway verb inside a ``deadline_scope``.

    The v1 data plane got per-verb deadlines in the gray-failure PR (see
    ``repro_torch.api.gateway._deadlined``, which layers breaker accounting and
    long-poll budgets on top). This is the plane-agnostic core of that
    rule for the v2 admin/workload gateways: a verb that outlives its
    budget answers a stable ``DEADLINE_EXCEEDED`` (HTTP 504) instead of
    wedging the caller behind a gray-failing shard. The budget is read
    from ``getattr(self, attr)`` when present so drills and benchmarks
    can tighten a live gateway, falling back to ``budget_s``.

    The DEADLINE-VERB analyzer (``python -m repro.analysis``) enforces
    that every ``*Gateway`` method taking ``api_key`` is wrapped in this
    (or opens a ``deadline_scope`` itself).
    """
    def decorate(fn):
        name = fn.__name__

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            # Core stays importable without the API tier, not the other
            # way round: importing the deadline plane here is cycle-free,
            # but lazy keeps types.py usable in stripped-down contexts.
            from repro_torch.core.faults import DeadlineExceeded, deadline_scope
            budget = getattr(self, attr, None) or budget_s
            try:
                with deadline_scope(budget):
                    return fn(self, *args, **kwargs)
            except DeadlineExceeded:
                raise ApiError(
                    ErrorCode.DEADLINE_EXCEEDED,
                    f"{name} exceeded its {budget:.2f}s deadline budget",
                    verb=name, budget_s=round(budget, 3))
        return wrapper
    return decorate


# --------------------------------------------------------------------------
# Envelopes
# --------------------------------------------------------------------------

@dataclass
class SubmitRequest:
    manifest: JobManifest
    # Client-supplied dedup token: two submits with the same (tenant, key)
    # return the same job id, even across a metastore crash/recover — the
    # mapping is journaled in the WAL before the first ack.
    idempotency_key: Optional[str] = None
    api_version: str = API_VERSION


@dataclass
class SubmitResponse:
    job_id: str
    deduplicated: bool = False   # True when an idempotency key was replayed
    api_version: str = API_VERSION


@dataclass
class JobView:
    """Tenant-visible projection of a JobRecord (no placement internals)."""

    job_id: str
    name: str
    tenant: str
    status: str
    submitted_at: float
    finished_at: Optional[float] = None
    progress_step: int = 0
    message: str = ""
    api_version: str = API_VERSION

    @classmethod
    def of(cls, rec: JobRecord) -> "JobView":
        return cls(job_id=rec.job_id, name=rec.manifest.name,
                   tenant=rec.manifest.tenant, status=rec.status.value,
                   submitted_at=rec.submitted_at, finished_at=rec.finished_at,
                   progress_step=rec.progress_step, message=rec.message)


@dataclass
class Page(Generic[T]):
    """One page of a cursor-paginated listing.

    ``next_cursor`` is opaque to clients: pass it back verbatim to fetch the
    next page; ``None`` means exhausted. Cursors remain valid under
    concurrent submits/appends (new items only ever land after them).
    """

    items: List[T] = field(default_factory=list)
    # Opaque; three shapes exist behind it, all stable under concurrent
    # appends: job ids (listings), append offsets (logs/search), and the
    # composite multi-shard form (admin reads over a federation; one
    # per-shard cursor per shard — see repro_torch.api.router).
    next_cursor: Optional[str] = None
    api_version: str = API_VERSION


def check_version(api_version: str):
    if api_version not in SUPPORTED_VERSIONS:
        raise ApiError(ErrorCode.UNSUPPORTED_VERSION,
                       f"api_version {api_version!r} not in "
                       f"{SUPPORTED_VERSIONS}")
