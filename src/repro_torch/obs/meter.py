"""Per-tenant usage metering (FfDL §4: the billing/diagnosis requirement).

One :class:`UsageMeter` per shard, owned by its platform. Sources:

  * **chip-seconds** — accrued by ``FfDLPlatform.tick()`` for every job
    holding chips that round (``gang_chips × tick_period`` while the job
    is in a chip-holding status), so a federation aggregates usage one
    tick at a time — exactly the cadence the paper bills at;
  * **job outcomes** — ``jobs_submitted`` / ``jobs_completed`` /
    ``jobs_failed``, tapped off the shard's event bus (:func:`install_meter`
    subscribes to the lifecycle kinds; the bus stamps each event with its
    tenant via the platform's resolver);
  * **log bytes** — the ``LogIndex`` append hook (bytes of every line a
    tenant's learners emit through the collector; migrated lines are NOT
    re-billed on import);
  * **429s** — ``throttled_429s``, tapped off the ``rate_limited`` events
    the rate limiter emits (satellite: throttling is operator-visible).

The meter is wire-addressable as ``GET /v1/usage`` (a tenant sees its own
row, an admin sees all, summed across every shard) and feeds the
per-tenant families of ``GET /metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

# The pinned usage-resource field vocabulary (docs/api.md).
# serving_replica_seconds: ready inference replicas × tick_period,
# accrued by the workloads reconciler at the same cadence chip_seconds
# accrue (a replica that is up but not yet ready bills chips, not this).
USAGE_FIELDS = ("chip_seconds", "jobs_submitted", "jobs_completed",
                "jobs_failed", "log_bytes", "throttled_429s",
                "serving_replica_seconds")

# event kind → usage field, for the bus tap
_KIND_FIELD = {
    "job_submitted": "jobs_submitted",
    "job_completed": "jobs_completed",
    "job_failed": "jobs_failed",
    "rate_limited": "throttled_429s",
}


class UsageMeter:
    """Thread-safe per-tenant counters; ``chip_seconds`` is a float,
    everything else integers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_tenant: Dict[str, dict] = {}

    def _row(self, tenant: str) -> dict:
        row = self._by_tenant.get(tenant)
        if row is None:
            row = self._by_tenant[tenant] = dict.fromkeys(USAGE_FIELDS, 0)
            row["chip_seconds"] = 0.0
        return row

    def bump(self, tenant: str, field: str, n=1):
        if field not in USAGE_FIELDS:
            raise ValueError(f"unknown usage field {field!r}")
        with self._lock:
            self._row(tenant)[field] += n

    def get(self, tenant: str) -> dict:
        with self._lock:
            return dict(self._by_tenant.get(tenant) or
                        dict.fromkeys(USAGE_FIELDS, 0))

    def snapshot(self) -> Dict[str, dict]:
        """``{tenant: {field: value}}`` — a consistent copy."""
        with self._lock:
            return {t: dict(row) for t, row in self._by_tenant.items()}

    @staticmethod
    def merge(snapshots: Iterable[Dict[str, dict]],
              tenant: Optional[str] = None) -> Dict[str, dict]:
        """Sum per-shard snapshots into one usage view (optionally for a
        single tenant) — a migrated tenant's history stays whole because
        both shards' meters contribute."""
        merged: Dict[str, dict] = {}
        for snap in snapshots:
            for t, row in snap.items():
                if tenant is not None and t != tenant:
                    continue
                agg = merged.setdefault(t, dict.fromkeys(USAGE_FIELDS, 0))
                for f in USAGE_FIELDS:
                    agg[f] += row.get(f, 0)
        return merged


def install_meter(bus, meter: UsageMeter):
    """Subscribe ``meter`` to the lifecycle/backpressure kinds on ``bus``.
    Events without a resolved tenant are not billed (there is nobody to
    bill them to); they stay visible to admins on /v2/events."""
    def tap(e):
        field = _KIND_FIELD.get(e.kind)
        if field is not None and e.tenant is not None:
            meter.bump(e.tenant, field)
    bus.subscribe(tap)
