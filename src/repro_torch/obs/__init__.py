# The observability plane (FfDL §4), the port's copy of the reference's
# ``repro.obs``: the sensor layer the platform's operators, human and
# autonomous, read. Five parts (the HTTP routes and the CLI that serve
# them are the reference's, ``repro.api.http`` and ``repro.api.cli``):
#   * bus:     per-shard, sequence-numbered, retention-bounded event bus
#              (promoted from core.types.EventLog) with tenant-scoped
#              visibility, served as GET /v2/events with cursor replay;
#   * meter:   per-tenant usage metering (chip-seconds, job outcomes, log
#              bytes, 429s), served as GET /v1/usage and via /metrics;
#   * metrics: a dependency-free Prometheus text exposition (counters,
#              gauges, histograms) behind GET /metrics;
#   * sse:     Server-Sent-Events framing for the true-streaming transport
#              behind `ffdl logs --follow` / `status --watch` / `events
#              --follow` (long-poll remains the fallback contract);
#   * operator: the autonomous reconciler (shard autoscaling, hot-tenant
#              isolation, health-gated rolling upgrades) closing the loop
#              over the sensors above via the /v2/admin verbs.
from repro_torch.obs.bus import (
    DEFAULT_RETENTION,
    Event,
    EventBus,
    PLATFORM_EVENT_KINDS,
    event_to_wire,
)
from repro_torch.obs.meter import USAGE_FIELDS, UsageMeter, install_meter
from repro_torch.obs.operator import (
    OPERATOR_EVENT_KINDS,
    Operator,
    OperatorConfig,
    OperatorPolicy,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Histogram,
    METRIC_NAMES,
    render_metrics,
)
from repro_torch.obs.sse import (
    SSE_CONTENT_TYPE,
    SseMessage,
    format_comment,
    format_event,
    iter_sse,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_RETENTION",
    "Event",
    "EventBus",
    "Histogram",
    "METRIC_NAMES",
    "OPERATOR_EVENT_KINDS",
    "Operator",
    "OperatorConfig",
    "OperatorPolicy",
    "PLATFORM_EVENT_KINDS",
    "SSE_CONTENT_TYPE",
    "SseMessage",
    "USAGE_FIELDS",
    "UsageMeter",
    "event_to_wire",
    "format_comment",
    "format_event",
    "install_meter",
    "iter_sse",
    "render_metrics",
]
