# The replicated, versioned API tier fronting the platform (FfDL §3.2),
# the port's copy of the reference's ``repro.api``: typed envelopes and
# stable error codes, per-tenant auth, idempotent submit, cursor
# pagination, round-robin failover across stateless replicas, per-tenant
# rate limiting, the v2 admin plane, the federation that routes tenants
# to independent backend shards, each behind its own readers-writer lock,
# a JSON-over-HTTP transport, and the ``ffdl`` CLI speaking only the wire
# protocol (python -m repro_torch.api.cli).
from repro_torch.api.admin import AdminGateway, AdminPlane, MigrationPhase
from repro_torch.api.auth import (
    ADMIN,
    ALL_TENANTS,
    AuthService,
    Principal,
    READ,
    WRITE,
)
from repro_torch.api.backend import AllShardsLock, Backend, RWLock
from repro_torch.api.client import AdminClient, ApiClient, RetryPolicy, WorkloadClient
from repro_torch.api.gateway import ApiGateway
from repro_torch.api.http import (
    ADMIN_ROUTES,
    ApiHttpServer,
    HttpTransport,
    OBS_ROUTES,
    ROUTES,
    STATUS_OF,
    WORKLOAD_ROUTES,
)
from repro_torch.api.lb import LoadBalancer
from repro_torch.api.ratelimit import RateLimitConfig, RateLimitedApi, TokenBucket
from repro_torch.api.router import TenantRouter
from repro_torch.api.types import (
    ADMIN_API_VERSION,
    API_VERSION,
    ApiError,
    ErrorCode,
    JobView,
    Page,
    SubmitRequest,
    SubmitResponse,
)
# Federation composes FfDLPlatform shards, which import repro_torch.api.*:
# keep it last so the submodules above are fully initialized first.
from repro_torch.api.federation import Federation, JOB_ID_STRIDE

__all__ = [
    "ADMIN",
    "ADMIN_API_VERSION",
    "ADMIN_ROUTES",
    "ALL_TENANTS",
    "API_VERSION",
    "AdminClient",
    "AdminGateway",
    "AdminPlane",
    "AllShardsLock",
    "ApiClient",
    "ApiError",
    "ApiGateway",
    "ApiHttpServer",
    "AuthService",
    "Backend",
    "ErrorCode",
    "Federation",
    "HttpTransport",
    "JOB_ID_STRIDE",
    "JobView",
    "LoadBalancer",
    "MigrationPhase",
    "OBS_ROUTES",
    "Page",
    "Principal",
    "RateLimitConfig",
    "RateLimitedApi",
    "READ",
    "RetryPolicy",
    "ROUTES",
    "RWLock",
    "STATUS_OF",
    "SubmitRequest",
    "SubmitResponse",
    "TenantRouter",
    "TokenBucket",
    "WRITE",
    "WORKLOAD_ROUTES",
    "WorkloadClient",
]
