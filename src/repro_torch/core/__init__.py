# The paper's primary contribution: the FfDL multi-tenant platform —
# scheduler (gang/BSA/PACK), lifecycle (LCM/Guardian), coordination
# (etcd-like), metadata (Mongo-like), helpers, admission, chaos — the
# port's copy of the reference's ``repro.core``, whose guardian builds a
# ``TorchLearner`` for a real job.
# ``FfDLPlatform`` is exported lazily (PEP 562): the platform pulls in the
# API tier (repro_torch.api), whose modules import repro_torch.core.types —
# importing it eagerly here would close that loop into a cycle.
from repro_torch.core.chaos import ChaosConfig, ChaosMonkey
from repro_torch.core.types import (
    TRAIN_SPEC_FIELDS,
    EventLog,
    JobManifest,
    JobRecord,
    JobStatus,
    Pod,
    PodPhase,
    SimClock,
    WallClock,
    unknown_spec_fields,
)

__all__ = [
    "ChaosConfig",
    "ChaosMonkey",
    "FfDLPlatform",
    "EventLog",
    "JobManifest",
    "JobRecord",
    "JobStatus",
    "Pod",
    "PodPhase",
    "SimClock",
    "TRAIN_SPEC_FIELDS",
    "WallClock",
    "unknown_spec_fields",
]


def __getattr__(name):
    if name == "FfDLPlatform":
        from repro_torch.core.platform import FfDLPlatform
        return FfDLPlatform
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
