"""Declarative workload manifests: the spec-in half of the resource model.

The port's copy of the reference's ``repro/workloads/manifest.py``, unchanged.

FfDL's job spec (§3) is declarative at the single-job level; this module
extends it to whole *workloads* — the fiaas Application-CRD pattern: a
manifest describes desired state, the reconciler (:mod:`.reconciler`)
converges the platform to it, and the status block on the stored resource
reports how far along it is. Three kinds:

  * ``Pipeline`` — a DAG of named stages (train → eval → serve). Each
    stage either submits a v1 job (``job:`` — a :class:`JobManifest`
    field dict) or materializes a child ``Service`` (``service:``).
    ``after: [names]`` gates a stage on its predecessors' completion;
    ``retries:`` bounds per-stage resubmits before the pipeline is
    marked DEGRADED.
  * ``RecurringJob`` — one job spec re-submitted every ``every_ticks``
    platform ticks, with an ``overlap:`` policy (``skip`` | ``allow`` |
    ``replace``) deciding what happens when the previous run is still
    live, and an optional ``max_runs``.
  * ``Service`` — a multi-tenant inference serving tier: ``replicas:``
    long-running replica jobs per tenant (each a platform job holding
    ``chips_per_replica`` chips), scaled by editing ``replicas:`` and
    re-applying.

Manifests arrive as JSON or as a **minimal, no-dependency YAML subset**
(:func:`parse_manifest_text`): nested mappings by 2-space-ish
indentation, ``- `` list items (inline-map form supported), inline flow
lists ``[a, b]``, ``#`` comments, and plain/quoted scalars with
JSON-style type inference. It is deliberately tiny — anything it cannot
parse is an ``INVALID_ARGUMENT``, never a guess.

Validation (:func:`validate_workload`) is strict the same way the v1
submit path is: unknown fields at any level are rejected with
``INVALID_ARGUMENT`` (satellite: typos in a manifest-derived spec must
not be maskable), stage DAGs must be acyclic with resolvable ``after``
references, and embedded job specs are checked against the
:class:`JobManifest` field vocabulary plus ``TRAIN_SPEC_FIELDS``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.api.types import ApiError, ErrorCode
from repro_torch.core.types import JobManifest, TRAIN_SPEC_FIELDS

WORKLOAD_KINDS = ("Pipeline", "RecurringJob", "Service")

OVERLAP_POLICIES = ("skip", "allow", "replace")

_JOB_FIELDS = {f.name for f in dataclasses.fields(JobManifest)}

# Per-kind field vocabularies (strict: unknown keys are rejected).
_COMMON_FIELDS = {"kind", "name", "tenant"}
_PIPELINE_FIELDS = _COMMON_FIELDS | {"stages"}
_STAGE_FIELDS = {"name", "job", "service", "after", "retries"}
_RECURRING_FIELDS = _COMMON_FIELDS | {"job", "every_ticks", "overlap",
                                      "max_runs"}
_SERVICE_FIELDS = _COMMON_FIELDS | {"replicas", "chips_per_replica",
                                    "arch", "engine", "tier"}
_ENGINES = ("sim", "real")


def _bad(msg: str, **details) -> ApiError:
    return ApiError(ErrorCode.INVALID_ARGUMENT, msg, **details)


# --------------------------------------------------------------------------
# The YAML subset
# --------------------------------------------------------------------------

def _scalar(tok: str):
    """JSON-ish scalar inference for the YAML subset."""
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return json.loads(tok)
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("null", "~", ""):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _flow_list(tok: str) -> list:
    """``[a, b, c]`` → list of scalars (no nesting — manifests don't
    need it, and refusing beats guessing)."""
    inner = tok.strip()[1:-1].strip()
    if not inner:
        return []
    if "[" in inner or "{" in inner:
        raise _bad("nested flow collections are not in the YAML subset")
    return [_scalar(p) for p in inner.split(",")]


def _split_key(line: str, lineno: int):
    """``key: value`` → (key, value-token); value may be empty."""
    if ":" not in line:
        raise _bad(f"line {lineno}: expected 'key: value', got {line!r}")
    key, _, rest = line.partition(":")
    key = key.strip()
    if not key:
        raise _bad(f"line {lineno}: empty key")
    return key, rest.strip()


def parse_yaml(text: str):
    """Parse the minimal YAML subset. Returns dict/list/scalar."""
    lines = []
    for i, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw:
            raise _bad(f"line {i}: tabs are not allowed in manifests")
        stripped = raw.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        indent = len(stripped) - len(stripped.lstrip(" "))
        lines.append((i, indent, stripped.strip()))
    if not lines:
        raise _bad("empty manifest")
    value, nxt = _parse_block(lines, 0, lines[0][1])
    if nxt != len(lines):
        lineno = lines[nxt][0]
        raise _bad(f"line {lineno}: unexpected de-indent/content")
    return value


def _parse_block(lines, pos, indent):
    """Parse one block (mapping or list) at exactly ``indent``."""
    if lines[pos][2].startswith("- ") or lines[pos][2] == "-":
        return _parse_list(lines, pos, indent)
    return _parse_map(lines, pos, indent)


def _parse_map(lines, pos, indent):
    out = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _bad(f"line {lineno}: unexpected indent")
        if content.startswith("- "):
            raise _bad(f"line {lineno}: list item in a mapping block")
        key, tok = _split_key(content, lineno)
        if key in out:
            raise _bad(f"line {lineno}: duplicate key {key!r}")
        pos += 1
        if tok:
            out[key] = _flow_list(tok) if tok.startswith("[") else \
                _scalar(tok)
        else:
            # nested block (or an explicitly empty value at EOF/dedent)
            if pos < len(lines) and lines[pos][1] > indent:
                out[key], pos = _parse_block(lines, pos, lines[pos][1])
            else:
                out[key] = None
    return out, pos


def _parse_list(lines, pos, indent):
    out = []
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _bad(f"line {lineno}: unexpected indent")
        if not (content.startswith("- ") or content == "-"):
            break
        body = content[2:].strip() if content.startswith("- ") else ""
        pos += 1
        if not body:
            # "-" alone: nested block item
            if pos < len(lines) and lines[pos][1] > indent:
                item, pos = _parse_block(lines, pos, lines[pos][1])
                out.append(item)
            else:
                out.append(None)
            continue
        if ":" in body and not body.startswith(("[", '"', "'")):
            # inline-map item: "- name: train" opens a mapping whose
            # continuation lines are indented past the dash
            key, tok = _split_key(body, lineno)
            item = {key: (_flow_list(tok) if tok.startswith("[")
                          else _scalar(tok)) if tok else None}
            if tok == "" and pos < len(lines) and \
                    lines[pos][1] > indent + 2:
                item[key], pos = _parse_block(lines, pos, lines[pos][1])
            if pos < len(lines) and lines[pos][1] == indent + 2 and \
                    not lines[pos][2].startswith("- "):
                rest, pos = _parse_map(lines, pos, indent + 2)
                for k, v in rest.items():
                    if k in item:
                        raise _bad(f"duplicate key {k!r} in list item")
                    item[k] = v
            out.append(item)
        else:
            out.append(_flow_list(body) if body.startswith("[")
                       else _scalar(body))
    return out, pos


def parse_manifest_text(text: str) -> dict:
    """JSON (leading ``{``) or the YAML subset → a raw manifest dict."""
    if not isinstance(text, str) or not text.strip():
        raise _bad("empty manifest text")
    if text.lstrip().startswith("{"):
        try:
            d = json.loads(text)
        except ValueError as e:
            raise _bad(f"manifest is not valid JSON: {e}")
    else:
        d = parse_yaml(text)
    if not isinstance(d, dict):
        raise _bad("manifest must be a mapping at the top level")
    return d


# --------------------------------------------------------------------------
# Validation → normalized spec
# --------------------------------------------------------------------------

def _require_str(d: dict, key: str, where: str) -> str:
    v = d.get(key)
    if not isinstance(v, str) or not v:
        raise _bad(f"{where}.{key} must be a non-empty string")
    return v


def _int_field(d: dict, key: str, where: str, default=None,
               minimum: int = 0) -> Optional[int]:
    v = d.get(key, default)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise _bad(f"{where}.{key} must be an integer")
    if v < minimum:
        raise _bad(f"{where}.{key} must be >= {minimum}")
    return v


def validate_job_spec(d, where: str, tenant: str) -> dict:
    """An embedded v1 job spec: JobManifest fields minus ``tenant``
    (inherited from the workload), strict on unknown keys at both the
    manifest and ``train:`` levels — the same hygiene the v1 submit
    path enforces, applied at apply() time so a bad stage spec fails
    the whole manifest before anything runs."""
    if not isinstance(d, dict):
        raise _bad(f"{where} must be a mapping of JobManifest fields")
    unknown = sorted(set(d) - _JOB_FIELDS)
    if unknown:
        raise _bad(f"{where}: unknown job spec fields: {unknown}")
    if d.get("tenant") not in (None, tenant):
        raise _bad(f"{where}.tenant must be omitted or {tenant!r}")
    train = d.get("train", {})
    if not isinstance(train, dict):
        raise _bad(f"{where}.train must be a mapping")
    bad = sorted(set(train) - set(TRAIN_SPEC_FIELDS))
    if bad:
        raise _bad(f"{where}.train: unknown train spec fields: {bad} "
                   f"(known: {list(TRAIN_SPEC_FIELDS)})")
    out = dict(d)
    out.pop("tenant", None)
    return out


def _validate_service_fields(d: dict, where: str) -> dict:
    unknown = sorted(set(d) - _SERVICE_FIELDS)
    if unknown:
        raise _bad(f"{where}: unknown Service fields: {unknown}")
    out = {
        "replicas": _int_field(d, "replicas", where, default=1),
        "chips_per_replica": _int_field(d, "chips_per_replica", where,
                                        default=1, minimum=1),
        "engine": d.get("engine", "sim"),
        "tier": d.get("tier", "paid"),
    }
    if d.get("arch") is not None:
        out["arch"] = _require_str(d, "arch", where)
    if out["engine"] not in _ENGINES:
        raise _bad(f"{where}.engine must be one of {list(_ENGINES)}")
    return out


def _validate_stages(stages, tenant: str) -> list:
    if not isinstance(stages, list) or not stages:
        raise _bad("Pipeline.stages must be a non-empty list")
    names = []
    out = []
    for i, s in enumerate(stages):
        where = f"stages[{i}]"
        if not isinstance(s, dict):
            raise _bad(f"{where} must be a mapping")
        unknown = sorted(set(s) - _STAGE_FIELDS)
        if unknown:
            raise _bad(f"{where}: unknown stage fields: {unknown}")
        name = _require_str(s, "name", where)
        if name in names:
            raise _bad(f"{where}: duplicate stage name {name!r}")
        names.append(name)
        after = s.get("after", [])
        if not isinstance(after, list) or \
                not all(isinstance(a, str) for a in after):
            raise _bad(f"{where}.after must be a list of stage names")
        has_job = s.get("job") is not None
        has_svc = s.get("service") is not None
        if has_job == has_svc:
            raise _bad(f"{where}: exactly one of job:/service: is required")
        stage = {"name": name, "after": sorted(set(after)),
                 "retries": _int_field(s, "retries", where, default=0)}
        if has_job:
            stage["job"] = validate_job_spec(s["job"], f"{where}.job",
                                             tenant)
        else:
            svc = s["service"]
            if not isinstance(svc, dict):
                raise _bad(f"{where}.service must be a mapping")
            svc = dict(svc)
            svc_name = svc.pop("name", None)
            stage["service"] = _validate_service_fields(
                {k: v for k, v in svc.items()}, f"{where}.service")
            if svc_name is not None:
                if not isinstance(svc_name, str) or not svc_name:
                    raise _bad(f"{where}.service.name must be a string")
                stage["service_name"] = svc_name
        out.append(stage)
    # DAG checks: references resolve, no cycles (Kahn over sorted names
    # so the canonical stage order is deterministic)
    known = set(names)
    deps = {s["name"]: set(s["after"]) for s in out}
    for s in out:
        missing = sorted(set(s["after"]) - known)
        if missing:
            raise _bad(f"stage {s['name']!r}: after references unknown "
                       f"stages {missing}")
        if s["name"] in s["after"]:
            raise _bad(f"stage {s['name']!r} depends on itself")
    order, ready = [], sorted(n for n, d in deps.items() if not d)
    remaining = {n: set(d) for n, d in deps.items() if d}
    while ready:
        n = ready.pop(0)
        order.append(n)
        newly = []
        for m, d in list(remaining.items()):
            d.discard(n)
            if not d:
                del remaining[m]
                newly.append(m)
        ready = sorted(ready + newly)
    if remaining:
        raise _bad(f"Pipeline.stages has a dependency cycle through "
                   f"{sorted(remaining)}")
    return out


def validate_workload(d) -> dict:
    """Raw manifest dict → normalized, strictly-validated spec dict.

    The returned dict is canonical: re-validating an equal input yields
    an equal output, which is what makes ``apply`` idempotence a simple
    spec comparison on the plane."""
    if not isinstance(d, dict):
        raise _bad("manifest must be a mapping")
    kind = d.get("kind")
    if kind not in WORKLOAD_KINDS:
        raise _bad(f"manifest.kind must be one of {list(WORKLOAD_KINDS)}, "
                   f"got {kind!r}")
    name = _require_str(d, "name", "manifest")
    tenant = _require_str(d, "tenant", "manifest")
    spec = {"kind": kind, "name": name, "tenant": tenant}

    if kind == "Pipeline":
        unknown = sorted(set(d) - _PIPELINE_FIELDS)
        if unknown:
            raise _bad(f"unknown Pipeline fields: {unknown}")
        spec["stages"] = _validate_stages(d.get("stages"), tenant)
    elif kind == "RecurringJob":
        unknown = sorted(set(d) - _RECURRING_FIELDS)
        if unknown:
            raise _bad(f"unknown RecurringJob fields: {unknown}")
        if d.get("job") is None:
            raise _bad("RecurringJob.job is required")
        spec["job"] = validate_job_spec(d["job"], "job", tenant)
        spec["every_ticks"] = _int_field(d, "every_ticks", "manifest",
                                         default=None, minimum=1)
        if spec["every_ticks"] is None:
            raise _bad("RecurringJob.every_ticks is required (>= 1)")
        spec["overlap"] = d.get("overlap", "skip")
        if spec["overlap"] not in OVERLAP_POLICIES:
            raise _bad(f"RecurringJob.overlap must be one of "
                       f"{list(OVERLAP_POLICIES)}")
        spec["max_runs"] = _int_field(d, "max_runs", "manifest",
                                     default=None, minimum=1)
    else:  # Service
        spec.update(_validate_service_fields(
            {k: v for k, v in d.items() if k not in _COMMON_FIELDS},
            "manifest"))
    return spec


def job_manifest_for(spec: dict, tenant: str, default_name: str) \
        -> JobManifest:
    """Normalized job spec dict → a typed JobManifest owned by ``tenant``."""
    d = dict(spec)
    d.setdefault("name", default_name)
    d["tenant"] = tenant
    return JobManifest(**d)
