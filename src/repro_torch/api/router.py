"""TenantRouter: deterministic tenant→shard placement (FfDL §3).

FfDL shards its MongoDB metastore and scales backend microservices
independently of the REST tier; the thing that keeps the wire contract
stable across that re-architecture is a *deterministic* mapping from
tenant to backend. We reproduce it as:

  * **hash-by-tenant** — SHA-256 of the tenant name modulo the shard
    count. Stable across processes and runs (no ``hash()`` randomization),
    so a tenant's jobs always live on one shard and any gateway replica
    resolves the same shard for the same key;
  * **an explicit pin table** — tests, benchmarks, and operators can place
    a tenant on a named shard (``pin("team-a", "shard-2")``), overriding
    the hash. Pins are how the federation drill puts one tenant per shard;
    the v2 admin plane (``repro.api.admin``) places tenants and flips
    their pin at migration cutover.

**Migration locks**: while a tenant is being rebalanced between shards,
its routing is frozen — ``pin``/``unpin`` answer ``FAILED_PRECONDITION``
so an operator's pin-table edit can never race the migration's cutover
(which flips the pin itself, atomically, under both shards' write locks,
via the internal ``_force_pin``). ``migration_target`` exposes the
in-flight destination so cross-shard reads can hide the half-imported
copy until cutover.

Cross-shard admin listings paginate behind a **composite cursor**: an
opaque string carrying one cursor per shard
(``ms1~shard-0=job-00004~shard-1=job-1000002``). For job listings each
entry is a position in that shard's **minting-id stream** — the
contiguous id interval the shard mints from, which a record belongs to
for life even after a migration moves it to another shard — so
already-served items never repeat and never go missing across cutovers;
for log search the entries are physical append offsets (at-least-once
across a cutover: never lost, possibly repeated once from the
destination). Items that arrive mid-iteration on a still-open stream are
picked up by a later page. A stream that answers an *empty* page is
marked **exhausted** with a ``!`` suffix on its segment
(``shard-0=job-00004!``) and is never queried again for the rest of the
walk — an admin paging through a mostly-drained federation stops paying
one probe per exhausted shard per page. Malformed composite cursors are
rejected with ``INVALID_ARGUMENT`` like any other bad cursor.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Optional, Set, Tuple

from repro_torch.api.types import ApiError, ErrorCode

# Composite-cursor wire prefix. Versioned so a future cursor format can
# coexist; everything after it is ``~shard_id=per_shard_cursor`` segments,
# with a ``!`` suffix marking a shard whose final page was already served.
COMPOSITE_PREFIX = "ms1"
EXHAUSTED_MARK = "!"

# What a valid per-shard cursor looks like, per surface.
JOB_CURSOR_RE = re.compile(r"job-\d+")
OFFSET_CURSOR_RE = re.compile(r"\d+")


class TenantRouter:
    """Deterministic tenant→Backend resolution over a fixed shard list."""

    def __init__(self, backends, pins: Optional[Dict[str, str]] = None):
        if not backends:
            raise ValueError("need at least one backend shard")
        self.backends = list(backends)
        self._by_id = {b.shard_id: b for b in self.backends}
        if len(self._by_id) != len(self.backends):
            raise ValueError("shard ids must be unique")
        self.pins: Dict[str, str] = {}
        # tenant → (src_shard_id, dst_shard_id) while a migration is live
        self._migrating: Dict[str, Tuple[str, str]] = {}
        for tenant, shard_id in (pins or {}).items():
            self.pin(tenant, shard_id)

    @property
    def shard_ids(self) -> list:
        return [b.shard_id for b in self.backends]

    def backend(self, shard_id: str):
        return self._by_id[shard_id]

    def pin(self, tenant: str, shard_id: str):
        """Place ``tenant`` on a named shard, overriding the hash."""
        if shard_id not in self._by_id:
            raise ValueError(f"unknown shard {shard_id!r} "
                             f"(have {sorted(self._by_id)})")
        self._check_not_migrating(tenant)
        self.pins[tenant] = shard_id

    def unpin(self, tenant: str):
        self._check_not_migrating(tenant)
        self.pins.pop(tenant, None)

    def shard_for(self, tenant: str):
        """The Backend owning ``tenant`` — pinned, else hashed.

        Cordon enforcement: a NEVER-SEEN tenant whose hash lands on a
        cordoned shard is deterministically re-hashed over the open
        shards (same digest, smaller modulus — pure, no state mutated by
        reads). Tenants already resident on a cordoned shard keep routing
        to it — cordon stops new placements, it does not evict. A write
        that is about to CREATE records calls :meth:`pin_for_write`
        first, which makes the reroute sticky (pinned), so lifting the
        cordon later cannot snap the hash back and orphan the records.
        """
        pinned = self.pins.get(tenant)
        if pinned is not None:
            return self._by_id[pinned]
        digest = int(hashlib.sha256(tenant.encode()).hexdigest(), 16)
        backend = self.backends[digest % len(self.backends)]
        if backend.cordoned and not self._resident(backend, tenant):
            rerouted = self._reroute(digest)
            if rerouted is not None:
                return rerouted
        return backend

    def _reroute(self, digest: int):
        open_backends = [b for b in self.backends if not b.cordoned]
        if not open_backends:
            return None
        return open_backends[digest % len(open_backends)]

    def pin_for_write(self, tenant: str):
        """Called before a record-creating write (submit): if the
        tenant's routing is currently a cordon reroute, PIN it there so
        the placement survives an uncordon. Reads never pin — a GET for
        an arbitrary tenant name must not grow the pin table or decide a
        future tenant's placement."""
        if tenant in self.pins or tenant in self._migrating:
            return
        digest = int(hashlib.sha256(tenant.encode()).hexdigest(), 16)
        backend = self.backends[digest % len(self.backends)]
        if backend.cordoned and not self._resident(backend, tenant):
            rerouted = self._reroute(digest)
            if rerouted is not None:
                self.pins[tenant] = rerouted.shard_id

    @staticmethod
    def _resident(backend, tenant: str) -> bool:
        """Does the shard already hold records for this tenant?"""
        try:
            return bool(backend.platform.meta._by_tenant.get(tenant))
        except Exception:  # metastore down: treat as resident (no reroute)
            return True

    # -- migration coordination (repro.api.admin) -------------------------
    def _check_not_migrating(self, tenant: str):
        """An operator pin-table edit must never race a live migration's
        cutover — the cutover itself flips the pin via ``_force_pin``."""
        if tenant in self._migrating:
            src, dst = self._migrating[tenant]
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"tenant {tenant!r} is migrating "
                           f"({src} -> {dst}); routing is frozen",
                           tenant=tenant, src=src, dst=dst)

    def lock_tenant(self, tenant: str, src_id: str, dst_id: str):
        if tenant in self._migrating:
            raise ApiError(ErrorCode.CONFLICT,
                           f"tenant {tenant!r} already has a live migration",
                           tenant=tenant)
        self._migrating[tenant] = (src_id, dst_id)

    def unlock_tenant(self, tenant: str):
        self._migrating.pop(tenant, None)

    def migration_target(self, tenant: str) -> Optional[str]:
        """Destination shard id of the tenant's live migration (None when
        not migrating). Cross-shard reads hide the destination's
        half-imported copy behind this until cutover."""
        entry = self._migrating.get(tenant)
        return entry[1] if entry else None

    def migrating_into(self, shard_id: str) -> list:
        """Tenants whose live migration is importing INTO ``shard_id``."""
        return [t for t, (_src, dst) in list(self._migrating.items())
                if dst == shard_id]

    def _force_pin(self, tenant: str, shard_id: str):
        """Cutover-internal pin flip: bypasses the migration freeze. Only
        the migration state machine calls this, under BOTH shards' write
        locks, so no v1 verb can observe a half-moved tenant."""
        if shard_id not in self._by_id:
            raise ValueError(f"unknown shard {shard_id!r}")
        self.pins[tenant] = shard_id


# --------------------------------------------------------------------------
# Composite cursors (cross-shard pagination)
# --------------------------------------------------------------------------

def encode_composite_cursor(cursors: Dict[str, str],
                            exhausted: Optional[Set[str]] = None) -> str:
    """``{shard_id: per_shard_cursor}`` (+ exhausted shard ids) → one
    opaque wire cursor. An exhausted shard keeps its last cursor (or an
    empty one if it never served an item) with a ``!`` suffix."""
    exhausted = exhausted or set()
    parts = []
    for sid in sorted(set(cursors) | exhausted):
        mark = EXHAUSTED_MARK if sid in exhausted else ""
        parts.append(f"{sid}={cursors.get(sid, '')}{mark}")
    return "~".join([COMPOSITE_PREFIX] + parts)


def parse_composite_cursor(cursor: Optional[str], router: TenantRouter,
                           item_re: re.Pattern
                           ) -> Tuple[Dict[str, str], Set[str]]:
    """Validate + decode a composite cursor into ``({shard_id: cursor},
    exhausted_shard_ids)``.

    Anything that is not exactly ``ms1`` followed by unique
    ``known_shard=valid_cursor`` segments (optionally ``!``-suffixed) is
    rejected with the stable ``INVALID_ARGUMENT`` code — a garbage cursor
    must never silently compare against real ids and serve a wrong (empty
    or duplicated) page.
    """
    if cursor is None:
        return {}, set()
    bad = ApiError(ErrorCode.INVALID_ARGUMENT,
                   f"malformed cursor: {cursor!r}")
    parts = str(cursor).split("~")
    if parts[0] != COMPOSITE_PREFIX or len(parts) < 2:
        raise bad
    out: Dict[str, str] = {}
    exhausted: Set[str] = set()
    for seg in parts[1:]:
        shard_id, eq, per_shard = seg.partition("=")
        if not eq or shard_id not in router._by_id \
                or shard_id in out or shard_id in exhausted:
            raise bad
        if per_shard.endswith(EXHAUSTED_MARK):
            exhausted.add(shard_id)
            per_shard = per_shard[:-len(EXHAUSTED_MARK)]
            if not per_shard:  # exhausted before serving a single item
                continue
        if not item_re.fullmatch(per_shard):
            raise bad
        out[shard_id] = per_shard
    return out, exhausted
