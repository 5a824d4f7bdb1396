# Declarative workloads: manifest resources (Pipeline / RecurringJob /
# Service) stored in a WorkloadPlane, served over /v2/workloads by a
# WorkloadGateway, and converged by a WorkloadReconciler stepped from
# Federation.tick — the control loop above the v1 job plane. The port's
# copy of the reference's ``repro.workloads``.
from repro_torch.workloads.manifest import (
    OVERLAP_POLICIES,
    WORKLOAD_KINDS,
    job_manifest_for,
    parse_manifest_text,
    parse_yaml,
    validate_workload,
)
from repro_torch.workloads.plane import (
    WorkloadGateway,
    WorkloadPlane,
    WorkloadRecord,
    initial_status,
)
from repro_torch.workloads.reconciler import (
    STAGE_TERMINAL,
    WORKLOAD_EVENT_KINDS,
    ReconcilerConfig,
    ReconcilerPolicy,
    WorkloadReconciler,
)

__all__ = [
    "OVERLAP_POLICIES",
    "ReconcilerConfig",
    "ReconcilerPolicy",
    "STAGE_TERMINAL",
    "WORKLOAD_EVENT_KINDS",
    "WORKLOAD_KINDS",
    "WorkloadGateway",
    "WorkloadPlane",
    "WorkloadReconciler",
    "WorkloadRecord",
    "initial_status",
    "job_manifest_for",
    "parse_manifest_text",
    "parse_yaml",
    "validate_workload",
]
