# The replicated, versioned v1 API tier fronting the platform (FfDL §3.2),
# the port's copy of the reference's ``repro.api``: typed envelopes and
# stable error codes, per-tenant auth, idempotent submit, cursor
# pagination, round-robin failover across stateless replicas, each shard
# behind its own readers-writer lock. The reference's v2 admin plane, rate
# limiting, HTTP transport, CLI and federation are not ported.
from repro_torch.api.auth import (
    ADMIN,
    ALL_TENANTS,
    AuthService,
    Principal,
    READ,
    WRITE,
)
from repro_torch.api.backend import AllShardsLock, Backend, RWLock
from repro_torch.api.client import ApiClient, RetryPolicy
from repro_torch.api.gateway import ApiGateway
from repro_torch.api.lb import LoadBalancer
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

__all__ = [
    "ADMIN",
    "ADMIN_API_VERSION",
    "ALL_TENANTS",
    "API_VERSION",
    "AllShardsLock",
    "ApiClient",
    "ApiError",
    "ApiGateway",
    "AuthService",
    "Backend",
    "ErrorCode",
    "JobView",
    "LoadBalancer",
    "Page",
    "Principal",
    "READ",
    "RWLock",
    "RetryPolicy",
    "SubmitRequest",
    "SubmitResponse",
    "TenantRouter",
    "WRITE",
]
