# The observability plane (FfDL §4), the port's copy of the reference's
# ``repro.obs``: the per-shard, sequence-numbered, retention-bounded event
# bus with tenant-scoped visibility (``bus``) and per-tenant usage metering
# (``meter``). The reference's Prometheus exposition (``metrics``), SSE
# framing (``sse``) and autonomous operator (``operator``) are not ported.
from repro_torch.obs.bus import (
    DEFAULT_RETENTION,
    Event,
    EventBus,
    PLATFORM_EVENT_KINDS,
    event_to_wire,
)
from repro_torch.obs.meter import USAGE_FIELDS, UsageMeter, install_meter

__all__ = [
    "DEFAULT_RETENTION",
    "Event",
    "EventBus",
    "PLATFORM_EVENT_KINDS",
    "USAGE_FIELDS",
    "UsageMeter",
    "event_to_wire",
    "install_meter",
]
