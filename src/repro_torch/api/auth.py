"""Per-tenant API-key authentication + scope checks (FfDL §3.2).

The paper's API tier authenticates every request and namespaces all job
state by tenant; one tenant can never read or halt another tenant's jobs.
We model that with opaque bearer keys issued per tenant:

  * ``issue_key(tenant, scopes)`` mints a key; scopes are ``read`` (status,
    logs, listings) and ``write`` (submit, halt, resume, cancel);
  * ``authenticate(key)`` resolves a :class:`Principal` or raises
    ``UNAUTHENTICATED``;
  * a principal for the wildcard tenant ``"*"`` is an operator/admin
    credential that may act across tenants (the platform's own facade uses
    one so legacy callers keep their pre-auth behaviour);
  * the ``admin`` scope gates the v2 admin control plane
    (``repro.api.admin``: tenants/quotas/shards/migrations as wire
    resources). A plain ``"*"`` read/write key can still use the v1
    cross-tenant *data*-plane reads, but cannot touch platform topology —
    mint an operator key with ``issue_admin_key()`` for that.

Keys are deterministic per AuthService instance (seeded counter + hash) so
simulations stay reproducible.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.api.types import ApiError, ErrorCode

READ = "read"
WRITE = "write"
ADMIN = "admin"  # v2 control plane: tenants, quotas, shards, migrations
ALL_TENANTS = "*"


@dataclass(frozen=True)
class Principal:
    tenant: str
    scopes: Tuple[str, ...]
    key_id: str

    @property
    def is_admin(self) -> bool:
        return self.tenant == ALL_TENANTS

    def can(self, scope: str) -> bool:
        return scope in self.scopes

    def owns(self, tenant: str) -> bool:
        return self.is_admin or self.tenant == tenant


class AuthService:
    def __init__(self, seed: int = 0):
        self._keys: Dict[str, Principal] = {}
        self._ctr = itertools.count(1)
        self._seed = seed

    def issue_key(self, tenant: str,
                  scopes: Tuple[str, ...] = (READ, WRITE)) -> str:
        n = next(self._ctr)
        digest = hashlib.sha256(
            f"{self._seed}:{tenant}:{n}".encode()).hexdigest()[:24]
        key = f"ffdl-{digest}"
        self._keys[key] = Principal(tenant=tenant, scopes=tuple(scopes),
                                    key_id=f"key-{n:04d}")
        return key

    def issue_admin_key(self) -> str:
        """Operator credential for the v2 admin plane: wildcard tenant plus
        the ``admin`` scope (and the data-plane scopes, so one key can both
        drive a migration and verify the tenant's jobs afterwards)."""
        return self.issue_key(ALL_TENANTS, scopes=(READ, WRITE, ADMIN))

    def revoke(self, key: str):
        self._keys.pop(key, None)

    def peek(self, api_key: str):
        """Resolve a key without raising — ``None`` for unknown keys. Used
        by the rate limiter to pick a bucket before authentication runs
        (unauthenticated floods must be throttleable too)."""
        return self._keys.get(api_key)

    def authenticate(self, api_key: str) -> Principal:
        principal = self._keys.get(api_key)
        if principal is None:
            raise ApiError(ErrorCode.UNAUTHENTICATED,
                           "unknown or revoked API key")
        return principal

    def require(self, api_key: str, scope: str) -> Principal:
        principal = self.authenticate(api_key)
        if not principal.can(scope):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"key {principal.key_id} lacks scope {scope!r}",
                           scope=scope)
        return principal
