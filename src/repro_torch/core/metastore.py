"""MetaStore: the MongoDB analogue (FfDL §3.2).

"When a job deployment request arrives, the API layer stores all the
metadata in MongoDB *before acknowledging the request*. This ensures that
submitted jobs are never lost [...] even if a catastrophic failure
temporarily takes down all machines in the cluster and all of FfDL core
microservices."

We reproduce exactly that contract: ``insert_job`` is durable-before-ack
(write-ahead journal appended and flushed before returning), and the whole
store can be rebuilt from the journal after a crash (``recover``).
Long-lived (spans jobs), per-tenant query-able job history included.

API-tier support: the idempotency-key index (``find_idempotent``) rides the
same WAL record as the insert, so duplicate-submit detection survives a
catastrophic crash/recover; ``jobs_page`` serves the gateway's
cursor-paginated, tenant-scoped listings (cursors key on the monotonically
increasing job id, so pages are stable under concurrent submits).

Hot-path indexing: listings used to re-sort every job id per request, so a
page cost O(total jobs ever) forever. The store now maintains sorted
secondary indexes — all ids, per tenant, per status, and per
(tenant, status) — incrementally on ``insert_job``/``update_status``;
``jobs_page`` resolves a page with one ``bisect`` + an index slice, and
``jobs``/``history`` walk the tenant index instead of scanning the table.

WAL group-commit: journal ops buffer in memory and are made durable by ONE
``write``+``flush`` per *public mutation* (or per ``batch()`` scope, which
amortises the flush across many mutations — the control-plane tick and
bulk ingest use this). ``insert_job`` outside a batch keeps the exact
durable-before-ack contract: its op is on disk before it returns.

Tenant rebalancing (the v2 admin plane, ``repro.api.admin``): a tenant's
slice of the store can be moved between shards with
``export_tenant``/``import_tenant``/``purge_tenant``. An export carries
(a) the tenant's journal ops past a watermark — replayed into the
destination's own WAL so the move is durable there — and (b) exact record
snapshots overlaying the fields the WAL does not journal (``finished_at``,
``progress_step``, restarts, the verbatim status history), so the imported
records are bit-for-bit equal to the source's. Re-exporting from the new
watermark yields only the mutations that landed during the copy (the
CATCHUP phase); ``purge_tenant`` journals the removal so a recovered
source shard does not resurrect a moved tenant.
"""

from __future__ import annotations

import json
from bisect import bisect_left, bisect_right, insort
from contextlib import contextmanager
from dataclasses import asdict
from typing import Optional

from repro_torch.core.types import JobManifest, JobRecord, JobStatus


def _idx_add(lst: list, jid: str):
    """Insert ``jid`` keeping ``lst`` sorted. Ids are minted monotonically,
    so the overwhelmingly common case is an append."""
    if not lst or lst[-1] < jid:
        lst.append(jid)
        return
    i = bisect_left(lst, jid)
    if i >= len(lst) or lst[i] != jid:  # tolerate re-inserts (replay)
        lst.insert(i, jid)


def _idx_del(lst: list, jid: str):
    i = bisect_left(lst, jid)
    if i < len(lst) and lst[i] == jid:
        del lst[i]


class MetaStore:
    def __init__(self, clock, journal_path: Optional[str] = None):
        self.clock = clock
        self._jobs: dict[str, JobRecord] = {}
        self._journal: list[dict] = []  # in-memory WAL (file-backed if path)
        # (tenant, idempotency_key) → job_id; rebuilt from the WAL on recover
        self._idem: dict[tuple[str, str], str] = {}
        # -- secondary indexes (sorted job-id lists), incrementally
        #    maintained; every read path below serves from these ----------
        self._order: list[str] = []
        self._by_tenant: dict[str, list[str]] = {}
        self._by_status: dict[JobStatus, list[str]] = {}
        self._by_tenant_status: dict[tuple[str, JobStatus], list[str]] = {}
        # -- WAL group-commit state ---------------------------------------
        self._pending: list[dict] = []  # ops not yet written to the file
        self._batch_depth = 0
        self.flushes = 0  # durability flushes issued (benchmark telemetry)
        self.journal_path = journal_path
        self._fh = open(journal_path, "a") if journal_path else None
        self.available = True
        # gray-failure interposition (wal.append / wal.flush): wired by the
        # owning platform to the shared FaultPlane; key scopes per shard
        self.faults = None
        self.fault_key: Optional[str] = None

    # -- chaos -----------------------------------------------------------
    def _check(self):
        if not self.available:
            raise ConnectionError("metastore unavailable")

    def crash(self):
        self.available = False

    def restart(self):
        self.available = True

    # -- WAL --------------------------------------------------------------
    def _append(self, op: dict):
        if self.faults is not None:
            # a slow/hung/failed WAL append surfaces as the same
            # ConnectionError the availability flag raises -> UNAVAILABLE
            self.faults.on("wal.append", key=self.fault_key,
                           exc=ConnectionError)
        self._journal.append(op)
        if self._fh:
            self._pending.append(op)

    def _commit(self):
        """Group commit: everything buffered since the last commit goes out
        in one write+flush. No-op inside a ``batch()`` scope — the batch
        exit issues the single flush for the whole group."""
        if self._batch_depth > 0:
            return
        if self.faults is not None:
            self.faults.on("wal.flush", key=self.fault_key,
                           exc=ConnectionError)
        if not self._pending:
            return
        if self._fh:
            self._fh.write("".join(json.dumps(op, default=str) + "\n"
                                   for op in self._pending))
            self._fh.flush()
            self.flushes += 1
        self._pending.clear()

    @contextmanager
    def batch(self):
        """Group-commit scope: ops from every mutation inside are made
        durable by ONE write+flush at exit (durable before the batch
        returns). Nested batches commit once, at the outermost exit."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            self._commit()

    @classmethod
    def recover(cls, clock, journal_path: str) -> "MetaStore":
        """Rebuild from the journal (catastrophic-failure recovery path)."""
        store = cls(clock)
        with open(journal_path) as fh:
            for line in fh:
                op = json.loads(line)
                store._replay(op)
        store.journal_path = journal_path
        store._fh = open(journal_path, "a")
        return store

    def replay_journal(self, journal: list[dict]):
        for op in journal:
            self._replay(op)

    def _replay(self, op: dict):
        if op["op"] == "insert":
            m = JobManifest(**op["manifest"])
            rec = JobRecord(job_id=op["job_id"], manifest=m,
                            submitted_at=op["ts"])
            rec.set_status(op["ts"], JobStatus.PENDING, "recovered")
            self._jobs[op["job_id"]] = rec
            self._index_insert(op["job_id"], m.tenant, JobStatus.PENDING)
            if op.get("idem"):
                self._idem[(m.tenant, op["idem"])] = op["job_id"]
        elif op["op"] == "status" and op["job_id"] in self._jobs:
            rec = self._jobs[op["job_id"]]
            old = rec.status
            rec.set_status(op["ts"], JobStatus(op["status"]),
                           op.get("msg", ""))
            self._index_restatus(op["job_id"], rec.manifest.tenant,
                                 old, rec.status)
        elif op["op"] == "purge_tenant":
            self._purge_tenant_state(op["tenant"])

    # -- index maintenance ------------------------------------------------
    def _index_insert(self, job_id: str, tenant: str, status: JobStatus):
        _idx_add(self._order, job_id)
        _idx_add(self._by_tenant.setdefault(tenant, []), job_id)
        _idx_add(self._by_status.setdefault(status, []), job_id)
        _idx_add(self._by_tenant_status.setdefault((tenant, status), []),
                 job_id)

    def _index_restatus(self, job_id: str, tenant: str,
                        old: JobStatus, new: JobStatus):
        if old == new:
            return
        _idx_del(self._by_status.get(old, []), job_id)
        _idx_del(self._by_tenant_status.get((tenant, old), []), job_id)
        _idx_add(self._by_status.setdefault(new, []), job_id)
        _idx_add(self._by_tenant_status.setdefault((tenant, new), []),
                 job_id)

    def _index_for(self, tenant: Optional[str],
                   status: Optional[JobStatus]) -> list[str]:
        """The narrowest sorted id list matching the filters."""
        if tenant is not None and status is not None:
            return self._by_tenant_status.get((tenant, status), [])
        if tenant is not None:
            return self._by_tenant.get(tenant, [])
        if status is not None:
            return self._by_status.get(status, [])
        return self._order

    # -- API ----------------------------------------------------------------
    def insert_job(self, job_id: str, manifest: JobManifest,
                   idempotency_key: Optional[str] = None) -> JobRecord:
        """Durable before ack — the WAL write+flush happens before
        returning (one group commit). The idempotency mapping rides the
        same WAL record as the insert, so duplicate detection survives
        crash/recover."""
        self._check()
        rec = JobRecord(job_id=job_id, manifest=manifest,
                        submitted_at=self.clock.now())
        rec.set_status(self.clock.now(), JobStatus.PENDING, "accepted")
        self._jobs[job_id] = rec
        self._index_insert(job_id, manifest.tenant, JobStatus.PENDING)
        if idempotency_key is not None:
            self._idem[(manifest.tenant, idempotency_key)] = job_id
        self._append({"op": "insert", "job_id": job_id, "ts": self.clock.now(),
                      "manifest": asdict(manifest),
                      "idem": idempotency_key})
        self._commit()
        return rec

    def find_idempotent(self, tenant: str, key: str) -> Optional[str]:
        """Job id previously acked for this (tenant, idempotency_key)."""
        self._check()
        return self._idem.get((tenant, key))

    def get(self, job_id: str) -> Optional[JobRecord]:
        self._check()
        return self._jobs.get(job_id)

    def update_status(self, job_id: str, status: JobStatus, msg: str = ""):
        self._check()
        rec = self._jobs[job_id]
        if rec.status != status or msg != rec.message:
            old = rec.status
            rec.set_status(self.clock.now(), status, msg)
            self._index_restatus(job_id, rec.manifest.tenant, old, status)
            self._append({"op": "status", "job_id": job_id,
                          "ts": self.clock.now(), "status": status.value,
                          "msg": msg})
            self._commit()

    def jobs(self, tenant: Optional[str] = None,
             status: Optional[JobStatus] = None) -> list[JobRecord]:
        self._check()
        recs = [self._jobs[jid] for jid in self._index_for(tenant, status)]
        return sorted(recs, key=lambda r: r.submitted_at)

    def jobs_page(self, tenant: Optional[str] = None,
                  status: Optional[JobStatus] = None,
                  cursor: Optional[str] = None,
                  limit: int = 20) -> tuple[list[JobRecord], Optional[str]]:
        """Cursor-paginated job listing in job-id order.

        The cursor is the last job id of the previous page; job ids are
        zero-padded and monotonically increasing, so already-served pages
        never shift when new jobs are submitted concurrently.
        Served from the matching secondary index: one ``bisect`` to find
        the cursor position, one slice for the page — exactly ``limit``
        records, with the next-cursor derived from the index position.
        Returns ``(records, next_cursor)``; ``next_cursor`` is ``None``
        once exhausted.
        """
        self._check()
        if limit is not None and limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        idx = self._index_for(tenant, status)
        start = bisect_right(idx, cursor) if cursor is not None else 0
        if limit is None:
            return [self._jobs[jid] for jid in idx[start:]], None
        page_ids = idx[start:start + limit]
        more = start + limit < len(idx)
        return ([self._jobs[jid] for jid in page_ids],
                page_ids[-1] if more else None)

    def jobs_span(self, lo: Optional[str] = None, hi: Optional[str] = None,
                  status: Optional[JobStatus] = None,
                  cursor: Optional[str] = None,
                  limit: int = 20) -> list[JobRecord]:
        """Records with ``max(lo, cursor) < job_id <= hi`` in id order, at
        most ``limit``. The federated admin walk uses this to page one
        *minting-shard id stream* (a contiguous id interval) out of any
        shard's index — including ids that migrated in from another shard.
        """
        self._check()
        idx = self._index_for(None, status)
        start_key = lo
        if cursor is not None and (start_key is None or cursor > start_key):
            start_key = cursor
        start = bisect_right(idx, start_key) if start_key is not None else 0
        end = bisect_right(idx, hi) if hi is not None else len(idx)
        return [self._jobs[jid] for jid in idx[start:min(start + limit, end)]]

    def history(self, tenant: str) -> list[dict]:
        """Per-tenant job history (the 'business artifact' query)."""
        return [
            {"job_id": r.job_id, "name": r.manifest.name,
             "status": r.status.value, "submitted_at": r.submitted_at,
             "finished_at": r.finished_at}
            for r in self.jobs(tenant=tenant)
        ]

    # -- tenant rebalancing (repro.api.admin migrations) -------------------
    @staticmethod
    def _record_to_wire(rec: JobRecord) -> dict:
        """Exact, JSON-able snapshot of one record (models a wire copy)."""
        return {
            "job_id": rec.job_id, "manifest": asdict(rec.manifest),
            "status": rec.status.value,
            "status_history": [list(h) for h in rec.status_history],
            "submitted_at": rec.submitted_at,
            "scheduled_at": rec.scheduled_at,
            "finished_at": rec.finished_at,
            "placement": dict(rec.placement) if rec.placement else None,
            "restarts": rec.restarts, "deploy_retries": rec.deploy_retries,
            "progress_step": rec.progress_step, "message": rec.message,
        }

    @staticmethod
    def _record_from_wire(d: dict) -> JobRecord:
        rec = JobRecord(job_id=d["job_id"],
                        manifest=JobManifest(**d["manifest"]),
                        submitted_at=d["submitted_at"])
        rec.status = JobStatus(d["status"])
        rec.status_history = [tuple(h) for h in d["status_history"]]
        rec.scheduled_at = d["scheduled_at"]
        rec.finished_at = d["finished_at"]
        rec.placement = dict(d["placement"]) if d["placement"] else None
        rec.restarts = d["restarts"]
        rec.deploy_retries = d["deploy_retries"]
        rec.progress_step = d["progress_step"]
        rec.message = d["message"]
        return rec

    def export_tenant(self, tenant: str, since: int = 0) -> dict:
        """Consistent snapshot of one tenant's slice of the store.

        ``ops`` are the tenant's journal entries with index >= ``since``
        (only for jobs still live — a previously purged tenant exports
        nothing); ``records`` are exact snapshots carrying the fields the
        WAL does not journal. A FULL export (``since=0``) snapshots every
        record; a delta export snapshots only the jobs the delta ops
        touched — any record still mutating mutates through journaled
        status flips (the migration quiesce guarantees this before the
        final delta), so a delta-untouched record is identical to the
        copy the previous export already delivered. ``watermark`` is the
        journal position to pass as ``since`` on the next export. Call
        under the shard's lock for a consistent cut.
        """
        self._check()
        jids = set(self._by_tenant.get(tenant, []))
        ops = []
        for op in self._journal[since:]:
            if op["op"] == "purge_tenant":
                continue  # a fresh import must not carry an old purge
            if op.get("job_id") in jids:
                ops.append(op)
        snap_ids = jids if since == 0 else {op["job_id"] for op in ops}
        return {
            "tenant": tenant,
            "ops": ops,
            "records": {jid: self._record_to_wire(self._jobs[jid])
                        for jid in snap_ids},
            "idem": {key: jid for (t, key), jid in self._idem.items()
                     if t == tenant},
            "watermark": len(self._journal),
        }

    def import_tenant(self, snap: dict):
        """Install an ``export_tenant`` snapshot into THIS store.

        The source's ops are appended to the local WAL (one group commit),
        so the moved tenant survives a crash/recover of the destination;
        the record snapshots then overwrite the in-memory records exactly
        (bit-for-bit with the source, including status history and the
        non-journaled fields). Re-imports are idempotent: a record already
        present is replaced, not duplicated.
        """
        self._check()
        with self.batch():
            for op in snap["ops"]:
                self._append(op)
            for jid, wire in snap["records"].items():
                old = self._jobs.get(jid)
                if old is not None:
                    self._index_remove(jid, old.manifest.tenant, old.status)
                rec = self._record_from_wire(wire)
                self._jobs[jid] = rec
                self._index_insert(jid, rec.manifest.tenant, rec.status)
            for key, jid in snap["idem"].items():
                self._idem[(snap["tenant"], key)] = jid

    def purge_tenant(self, tenant: str) -> list[str]:
        """Remove every record of ``tenant`` (post-cutover source cleanup,
        or rollback of a partial import on an aborted migration). Journaled,
        so recovering this shard's WAL does not resurrect the moved tenant.
        Returns the purged job ids."""
        self._check()
        purged = self._purge_tenant_state(tenant)
        if purged:
            self._append({"op": "purge_tenant", "tenant": tenant,
                          "ts": self.clock.now()})
            self._commit()
        return purged

    def _purge_tenant_state(self, tenant: str) -> list[str]:
        jids = list(self._by_tenant.get(tenant, []))
        for jid in jids:
            rec = self._jobs.pop(jid)
            self._index_remove(jid, tenant, rec.status)
        for key in [k for k in self._idem if k[0] == tenant]:
            del self._idem[key]
        return jids

    def _index_remove(self, job_id: str, tenant: str, status: JobStatus):
        _idx_del(self._order, job_id)
        _idx_del(self._by_tenant.get(tenant, []), job_id)
        _idx_del(self._by_status.get(status, []), job_id)
        _idx_del(self._by_tenant_status.get((tenant, status), []), job_id)
