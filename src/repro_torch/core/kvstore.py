"""EtcdLike: the coordination store (FfDL §3.2).

The paper: "We preferred etcd over MongoDB for coordination because it is
much faster and has some abstractions that MongoDB lacks, like leases on
keys and fine grained support for streaming watches at the level of a
single key." Data is small (<1KB), short-lived, erased when the job ends.

Semantics implemented (the subset FfDL relies on):
  * get / put / delete with per-key mod revision,
  * compare-and-swap (txn-lite),
  * TTL leases — keys attached to a lease vanish when it expires unless
    refreshed (the heartbeat/failure-detection primitive),
  * prefix watches — callbacks on put/delete under a prefix (the
    controller → Guardian status pipeline),
  * per-tenant namespacing (multi-tenancy isolation contract).

Replicated-etcd crash tolerance is modeled by ``crash()``/``restart()``
keeping data intact (Raft majority survives a member crash); benchmarks use
this for the recovery-time table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class _Entry:
    value: Any
    revision: int
    lease_id: Optional[int] = None


@dataclass
class _Lease:
    ttl: float
    expires_at: float
    keys: set = field(default_factory=set)


class EtcdLike:
    def __init__(self, clock, events=None):
        self.clock = clock
        self.events = events
        self._data: dict[str, _Entry] = {}
        self._leases: dict[int, _Lease] = {}
        self._watches: list[tuple[str, Callable]] = []
        self._rev = 0
        self._lease_ctr = 0
        self.available = True

    # -- availability (chaos) ------------------------------------------
    def _check(self):
        if not self.available:
            raise ConnectionError("etcd unavailable")

    def crash(self):
        self.available = False

    def restart(self):
        self.available = True

    # -- leases ----------------------------------------------------------
    def grant_lease(self, ttl: float) -> int:
        self._check()
        self._lease_ctr += 1
        self._leases[self._lease_ctr] = _Lease(
            ttl=ttl, expires_at=self.clock.now() + ttl)
        return self._lease_ctr

    def keepalive(self, lease_id: int) -> bool:
        self._check()
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.expires_at = self.clock.now() + lease.ttl
        return True

    def sweep_leases(self):
        """Expire leases; called by the platform tick."""
        now = self.clock.now()
        dead = [lid for lid, l in self._leases.items() if l.expires_at <= now]
        for lid in dead:
            lease = self._leases.pop(lid)
            for key in list(lease.keys):
                self._delete(key, expired=True)

    # -- kv ----------------------------------------------------------------
    def put(self, key: str, value: Any, lease_id: Optional[int] = None):
        self._check()
        self._rev += 1
        old = self._data.get(key)
        if old is not None and old.lease_id and old.lease_id in self._leases:
            self._leases[old.lease_id].keys.discard(key)
        self._data[key] = _Entry(value, self._rev, lease_id)
        if lease_id is not None and lease_id in self._leases:
            self._leases[lease_id].keys.add(key)
        self._notify(key, "put", value)

    def get(self, key: str, default=None):
        self._check()
        e = self._data.get(key)
        return e.value if e is not None else default

    def revision(self, key: str) -> Optional[int]:
        e = self._data.get(key)
        return e.revision if e else None

    def cas(self, key: str, expect_revision: Optional[int], value: Any) -> bool:
        """Put iff the key's mod revision matches (None = must not exist)."""
        self._check()
        cur = self._data.get(key)
        cur_rev = cur.revision if cur else None
        if cur_rev != expect_revision:
            return False
        self.put(key, value)
        return True

    def delete(self, key: str):
        self._check()
        self._delete(key)

    def _delete(self, key: str, expired: bool = False):
        e = self._data.pop(key, None)
        if e is None:
            return
        if e.lease_id and e.lease_id in self._leases:
            self._leases[e.lease_id].keys.discard(key)
        self._notify(key, "expired" if expired else "delete", None)

    def prefix(self, prefix: str) -> dict[str, Any]:
        self._check()
        return {k: e.value for k, e in self._data.items()
                if k.startswith(prefix)}

    def delete_prefix(self, prefix: str):
        self._check()
        for k in [k for k in self._data if k.startswith(prefix)]:
            self._delete(k)

    # -- watches -------------------------------------------------------
    def watch(self, prefix: str, fn: Callable[[str, str, Any], None]):
        """fn(key, op, value) on every put/delete/expire under prefix."""
        self._watches.append((prefix, fn))
        return lambda: self._watches.remove((prefix, fn))

    def _notify(self, key: str, op: str, value):
        for prefix, fn in list(self._watches):
            if key.startswith(prefix):
                fn(key, op, value)
