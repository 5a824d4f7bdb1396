"""The workloads resource plane: stored manifests + the /v2/workloads verbs.

The port's copy of the reference's ``repro/workloads/plane.py``, unchanged.

Mirrors the v2 admin plane split (:mod:`repro_torch.api.admin`): one
:class:`WorkloadPlane` per federation holds the applied manifests (spec +
reconciler-owned status), :class:`WorkloadGateway` is the auth-checking
verb surface served over HTTP and in-process. Unlike the admin plane the
workloads plane is **tenant-scoped**: a plain tenant key may apply, list,
get, delete, and invoke its *own* workloads; an admin key addresses any
tenant's (``tenant=`` selects which).

Resources are keyed ``(tenant, name)``. ``apply`` is idempotent by
construction — the normalized spec (:func:`..manifest.validate_workload`)
is compared structurally, and an equal re-apply changes nothing, bumps
nothing, and emits nothing. A changed spec bumps ``generation``;
pipelines restart from a clean DAG on a spec change, services and
recurring jobs carry their runtime state forward (scale by editing
``replicas:`` and re-applying).

``invoke`` is the serving tier's data path: it routes one inference
request to a ready replica of a RUNNING ``Service``, round-robin. Over
HTTP it rides the same per-tenant token buckets as every other tenant
call (``throttle_non_admin`` in the handler), which is what gives the
serving tier per-tenant QoS for free: a flooding tenant sees 429s, other
tenants' requests are untouched. When a real
:class:`repro_torch.launch.serve.ServeEngine` is attached
(:meth:`WorkloadPlane.attach_engine`), the invoke path drives it
in-process; otherwise the reply is a simulated echo carrying the routing
decision (which replica job served it).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.api.auth import READ, WRITE, AuthService
from repro_torch.api.types import (ADMIN_API_VERSION, ApiError, ErrorCode,
                             deadline_guarded)
from repro_torch.workloads.manifest import (
    parse_manifest_text,
    validate_workload,
)


def _serialized(fn):
    """Every public plane verb under the plane mutex (reentrant: delete
    cascades re-enter). Ordering is always plane mutex -> shard lock —
    the same order the reconciler uses — never the reverse."""
    def wrapper(self, *args, **kwargs):
        with self._mutex:
            return fn(self, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def initial_status(spec: dict) -> dict:
    """The reconciler-owned status block a fresh resource starts from."""
    kind = spec["kind"]
    if kind == "Pipeline":
        return {"phase": "PENDING",
                "stages": {s["name"]: {"state": "PENDING", "job": None,
                                       "attempts": 0, "service": None}
                           for s in spec["stages"]}}
    if kind == "RecurringJob":
        return {"phase": "ACTIVE", "runs": 0, "skipped": 0,
                "jobs": [], "last_run_tick": None}
    return {"phase": "PENDING", "replicas": {}, "ready_slots": [],
            "round_robin": 0, "invocations": 0}


@dataclass
class WorkloadRecord:
    """One applied manifest: the spec is the user's, the status block is
    the reconciler's, and nobody else writes either."""

    spec: dict
    generation: int = 1
    status: dict = field(default_factory=dict)
    # Set when a pipeline's serve stage applied this resource: deleting
    # the owner cascades here.
    owner: Optional[Tuple[str, str]] = None

    @property
    def kind(self) -> str:
        return self.spec["kind"]

    @property
    def tenant(self) -> str:
        return self.spec["tenant"]

    @property
    def name(self) -> str:
        return self.spec["name"]

    def to_wire(self) -> dict:
        return {"api_version": ADMIN_API_VERSION,
                "kind": self.kind, "name": self.name,
                "tenant": self.tenant, "generation": self.generation,
                "spec": copy.deepcopy(self.spec),
                "status": copy.deepcopy(self.status),
                "owner": (f"{self.owner[0]}/{self.owner[1]}"
                          if self.owner else None)}

    def tracked_jobs(self) -> list:
        """Every job id this resource currently references (sorted)."""
        st, out = self.status, []
        if self.kind == "Pipeline":
            out = [s["job"] for s in st.get("stages", {}).values()
                   if s.get("job")]
        elif self.kind == "RecurringJob":
            out = list(st.get("jobs", []))
        else:
            out = [j for j in st.get("replicas", {}).values() if j]
        return sorted(out)


class WorkloadPlane:
    """Shared manifest store + teardown plumbing. The reconciler
    (:class:`repro_torch.workloads.reconciler.WorkloadReconciler`) is the only
    writer of record status; the plane's own verbs only create, replace,
    and delete records."""

    def __init__(self, router, auth: AuthService):
        from repro_torch.api.gateway import ApiGateway
        self.router = router
        self.auth = auth
        self.records: Dict[Tuple[str, str], WorkloadRecord] = {}
        self._mutex = threading.RLock()
        # The plane acts on the v1 data plane exactly like a client would:
        # its own gateway replica + an operator key (same pattern as the
        # autonomous operator acting through /v2/admin verbs).
        self._api = ApiGateway(router, auth, replica_id="api-workloads")
        self._key = auth.issue_admin_key()
        # (tenant, name) -> in-process ServeEngine for `engine: real`
        self._engines: Dict[Tuple[str, str], object] = {}

    # -- plumbing ---------------------------------------------------------
    def _emit(self, kind: str, tenant: str, **fields):
        """Journal a workload event on the first live shard's bus (the
        same convention the autonomous operator uses)."""
        for b in self.router.backends:
            if b.alive and not getattr(b, "retired", False):
                b.platform.events.emit("workloads", kind, tenant=tenant,
                                       **fields)
                return

    def _get(self, tenant: str, name: str) -> WorkloadRecord:
        rec = self.records.get((tenant, name))
        if rec is None:
            raise ApiError(ErrorCode.NOT_FOUND,
                           f"no workload {name!r} for tenant {tenant!r}",
                           tenant=tenant, name=name)
        return rec

    # -- verbs ------------------------------------------------------------
    @_serialized
    def apply(self, manifest, owner: Optional[Tuple[str, str]] = None) \
            -> Tuple[dict, bool, bool]:
        """Upsert one manifest (raw dict or manifest text). Returns
        ``(view, created, changed)``; an equal re-apply is a full no-op
        (created=False, changed=False) — the idempotence the property
        tests pin."""
        if isinstance(manifest, str):
            manifest = parse_manifest_text(manifest)
        spec = validate_workload(manifest)
        key = (spec["tenant"], spec["name"])
        rec = self.records.get(key)
        if rec is None:
            rec = WorkloadRecord(spec=spec, status=initial_status(spec),
                                 owner=owner)
            self.records[key] = rec
            self._emit("workload_applied", spec["tenant"],
                       name=spec["name"], workload_kind=spec["kind"],
                       generation=1)
            return rec.to_wire(), True, True
        if rec.spec == spec:
            return rec.to_wire(), False, False
        if rec.kind != spec["kind"]:
            raise ApiError(ErrorCode.CONFLICT,
                           f"workload {spec['name']!r} exists with kind "
                           f"{rec.kind!r}; delete it before re-applying "
                           f"as {spec['kind']!r}")
        rec.spec = spec
        rec.generation += 1
        if owner is not None:
            rec.owner = owner
        if spec["kind"] == "Pipeline":
            # a changed pipeline is a new run: fresh DAG, old stage jobs
            # are left to finish (they were already paid for)
            rec.status = initial_status(spec)
        self._emit("workload_applied", spec["tenant"], name=spec["name"],
                   workload_kind=spec["kind"], generation=rec.generation)
        return rec.to_wire(), False, True

    @_serialized
    def get(self, tenant: str, name: str) -> dict:
        return self._get(tenant, name).to_wire()

    @_serialized
    def list(self, tenant: Optional[str] = None) -> list:
        return [rec.to_wire()
                for (t, _n), rec in sorted(self.records.items())
                if tenant is None or t == tenant]

    @_serialized
    def delete(self, tenant: str, name: str) -> dict:
        """Remove the resource and tear down everything it materialized:
        non-terminal tracked jobs are cancelled through the v1 gateway,
        and child resources a pipeline applied are deleted recursively."""
        rec = self._get(tenant, name)
        view = rec.to_wire()
        del self.records[(tenant, name)]
        for (t, n), child in sorted(self.records.items()):
            if child.owner == (tenant, name):
                self.delete(t, n)
        for job_id in rec.tracked_jobs():
            try:
                self._api.cancel(self._key, job_id)
            except ApiError:
                pass  # already terminal / unknown / shard down
        self._engines.pop((tenant, name), None)
        self._emit("workload_deleted", tenant, name=name,
                   workload_kind=rec.kind)
        return view

    @_serialized
    def invoke(self, tenant: str, name: str, payload=None) -> dict:
        """Route one inference request to a ready replica (round-robin)."""
        rec = self._get(tenant, name)
        if rec.kind != "Service":
            raise ApiError(ErrorCode.FAILED_PRECONDITION,
                           f"workload {name!r} is a {rec.kind}, not a "
                           f"Service")
        ready = list(rec.status.get("ready_slots", []))
        if not ready:
            raise ApiError(
                ErrorCode.FAILED_PRECONDITION,
                f"service {name!r} has no ready replicas "
                f"(phase {rec.status.get('phase')})",
                phase=rec.status.get("phase"))
        slot = ready[rec.status["round_robin"] % len(ready)]
        rec.status["round_robin"] += 1
        rec.status["invocations"] += 1
        job_id = rec.status["replicas"].get(slot)
        engine = self._engines.get((tenant, name))
        if engine is not None:
            output = engine.infer(payload)
        else:
            output = {"echo": payload, "engine": rec.spec.get("engine"),
                      "model": rec.spec.get("arch")}
        return {"api_version": ADMIN_API_VERSION, "service": name,
                "tenant": tenant, "replica": slot, "job": job_id,
                "output": output}

    @_serialized
    def attach_engine(self, tenant: str, name: str, engine):
        """Bind an in-process serving engine (anything with ``infer``,
        e.g. ``ServeEngine.session(...)`` wrapped) to a Service."""
        self._get(tenant, name)  # must exist
        self._engines[(tenant, name)] = engine


# Every WorkloadGateway verb runs inside a deadline scope (enforced by
# the DEADLINE-VERB check of the reference's repro.analysis).
_deadlined = deadline_guarded()


class WorkloadGateway:
    """Auth-checking verb surface over one shared plane — the in-process
    twin of the ``/v2/workloads`` HTTP routes. Tenant keys operate on
    their own tenant's resources; admin keys on anyone's."""

    # per-verb deadline budget; instances may tighten it (drills do)
    verb_budget_s = 10.0

    def __init__(self, plane: WorkloadPlane, auth: AuthService):
        self.plane = plane
        self.auth = auth

    def _resolve_tenant(self, principal, tenant: Optional[str]) -> str:
        """Which tenant is this call about? Tenant keys default (and are
        restricted) to their own; admin keys must say."""
        if tenant is None:
            if principal.is_admin:
                raise ApiError(ErrorCode.INVALID_ARGUMENT,
                               "admin keys must pass tenant=")
            return principal.tenant
        if not principal.owns(tenant):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"key for tenant {principal.tenant!r} cannot "
                           f"address workloads of {tenant!r}")
        return tenant

    @_deadlined
    def apply(self, api_key: str, manifest) -> dict:
        """``manifest``: raw dict, or JSON/YAML-subset text."""
        principal = self.auth.require(api_key, WRITE)
        if isinstance(manifest, str):
            manifest = parse_manifest_text(manifest)
        spec = validate_workload(manifest)
        if not principal.owns(spec["tenant"]):
            raise ApiError(ErrorCode.FORBIDDEN,
                           f"key for tenant {principal.tenant!r} cannot "
                           f"apply workloads for {spec['tenant']!r}")
        view, created, _changed = self.plane.apply(manifest)
        view["created"] = created
        return view

    @_deadlined
    def get_workload(self, api_key: str, name: str,
                     tenant: Optional[str] = None) -> dict:
        principal = self.auth.require(api_key, READ)
        return self.plane.get(self._resolve_tenant(principal, tenant), name)

    @_deadlined
    def list_workloads(self, api_key: str,
                       tenant: Optional[str] = None) -> dict:
        principal = self.auth.require(api_key, READ)
        if principal.is_admin:
            items = self.plane.list(tenant)  # None = every tenant
        else:
            items = self.plane.list(self._resolve_tenant(principal, tenant))
        return {"api_version": ADMIN_API_VERSION, "items": items}

    @_deadlined
    def delete_workload(self, api_key: str, name: str,
                        tenant: Optional[str] = None) -> dict:
        principal = self.auth.require(api_key, WRITE)
        return self.plane.delete(self._resolve_tenant(principal, tenant),
                                 name)

    @_deadlined
    def invoke_workload(self, api_key: str, name: str, payload=None,
                        tenant: Optional[str] = None) -> dict:
        principal = self.auth.require(api_key, READ)
        return self.plane.invoke(self._resolve_tenant(principal, tenant),
                                 name, payload)
