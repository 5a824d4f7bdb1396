"""Dependency-free Prometheus text exposition (format v0.0.4).

The port's copy of the reference's ``repro/obs/metrics.py``, unchanged.

``GET /metrics`` renders whatever the HTTP server scrapes out of its
platform at request time — no background collector thread, no external
client library. Three instrument shapes:

  * counters/gauges are plain numbers read off live objects (scrapes are
    monitoring reads: they tolerate torn values across families rather
    than taking every shard lock);
  * :class:`Histogram` is the one stateful instrument — cumulative
    buckets + sum + count, used for per-route request latency.

``METRIC_NAMES`` pins the family names as wire contract (docs/api.md and
docs/architecture.md map each to its source; tests/test_docs_api.py
enforces the mapping). Renaming one is a breaking change for operator
dashboards — add, don't rename.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

# Latency buckets in seconds, tuned for an in-process API: sub-ms for
# indexed reads through to the 10 s long-poll ceiling.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# The pinned family vocabulary (see docs/architecture.md for emit sites).
METRIC_NAMES = (
    "ffdl_uptime_ticks",
    "ffdl_shard_up",
    "ffdl_shard_chips_total",
    "ffdl_shard_occupancy_chips",
    "ffdl_scheduler_queue_depth",
    "ffdl_wal_flushes_total",
    "ffdl_breaker_state",
    "ffdl_deadline_exceeded_total",
    "ffdl_events_seq",
    "ffdl_events_dropped_total",
    "ffdl_migrations",
    "ffdl_http_requests_total",
    "ffdl_http_request_latency_seconds",
    "ffdl_http_streams_active",
    "ffdl_http_streams_opened_total",
    "ffdl_http_heartbeats_total",
    "ffdl_rate_limited_total",
    "ffdl_tenant_chip_seconds_total",
    "ffdl_tenant_jobs_total",
    "ffdl_tenant_log_bytes_total",
    "ffdl_tenant_serving_replica_seconds_total",
)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics): ``observe``
    is O(buckets); ``snapshot`` returns ``(bucket_counts, sum, count)``
    where ``bucket_counts[i]`` counts observations ≤ ``buckets[i]``."""

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1

    def snapshot(self):
        with self._lock:
            return list(self._counts), self._sum, self._count


def _escape(value: str) -> str:
    """Label-value escaping per the exposition format."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _num(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def render_metrics(families: list) -> str:
    """Render ``[(name, type, help, samples)]`` to exposition text.

    ``type`` is ``counter`` / ``gauge`` / ``histogram``. For scalar types
    each sample is ``(labels_dict_or_None, value)``; for histograms each
    sample is ``(labels_dict_or_None, Histogram)`` and expands to the
    ``_bucket``/``_sum``/``_count`` series with ``le`` labels.
    """
    out: list[str] = []
    for name, mtype, help_text, samples in families:
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if mtype == "histogram":
                counts, total, count = value.snapshot()
                base = dict(labels or {})
                for le, c in zip(value.buckets, counts):
                    out.append(f"{name}_bucket"
                               f"{_labels({**base, 'le': _num(float(le))})}"
                               f" {c}")
                out.append(f"{name}_bucket{_labels({**base, 'le': '+Inf'})}"
                           f" {count}")
                out.append(f"{name}_sum{_labels(base or None)} {_num(total)}")
                out.append(f"{name}_count{_labels(base or None)} {count}")
            else:
                out.append(f"{name}{_labels(labels)} {_num(value)}")
    return "\n".join(out) + "\n"
