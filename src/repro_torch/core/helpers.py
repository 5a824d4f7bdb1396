"""Helper services: log collection and the Training Metrics Service.

FfDL §3.2: "The Training Metrics Service is responsible for collecting
metrics about both the training jobs and FfDL microservices [...] It also
helps in streaming training logs from jobs to be indexed and stored in
ElasticSearch/Kibana."

``LogCollector`` streams learner log files off the job volume into the
searchable ``LogIndex`` (the ElasticSearch analogue), with gap-free resume
after collector crashes (offset bookkeeping — the 'surprisingly challenging'
§4 lesson). ``MetricsService`` aggregates job metrics and microservice
failure/recovery counters.
"""

from __future__ import annotations

import re
from array import array
from bisect import bisect_left
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.executor import JobVolume

# Token = maximal alphanumeric/underscore run. The inverted index is keyed
# on these; everything between tokens (delimiters) is re-checked by the
# substring verification, so the tokenizer never changes result sets.
_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


@dataclass
class LogRecord:
    ts: float
    job_id: str
    learner: int
    line: str


class LogIndex:
    """ElasticSearch-like: append + substring search, per-job streams.

    Both streams and searches are append-only, so integer offsets make
    stable pagination cursors: a page served earlier never shifts when new
    records arrive (they only land past every existing cursor). The
    API gateway serves its ``logs``/``search_logs`` pages from
    ``stream_page``/``search_page``.

    Search is served from a token-level **inverted index** (token →
    posting offsets, maintained globally and per job on ``append``):
    a query is compiled into token constraints, candidate offsets are the
    intersection of the matching posting lists, and each candidate is then
    verified with the exact ``query in line`` check — so results (and the
    integer scan-offset cursors) are identical to a full scan, without
    touching every record ever appended. Queries that contain no indexable
    token (pure punctuation/whitespace) fall back to the scan.
    """

    def __init__(self):
        # purge_jobs (tenant migration) tombstones records IN PLACE via a
        # `purged` flag: the list keeps its length and positions so
        # scan-offset cursors stay valid.
        self.records: list[LogRecord] = []
        self._by_job: dict[str, list[LogRecord]] = defaultdict(list)
        # token → sorted posting offsets (into self.records), and the same
        # per job (offsets into self._by_job[job_id])
        self._postings: dict[str, array] = {}
        self._job_postings: dict[str, dict[str, array]] = defaultdict(dict)
        # sorted vocab (+ reversed-token vocab for suffix constraints),
        # rebuilt lazily when new tokens appeared since the last search
        self._vocab: Optional[list[str]] = None
        self._rvocab: Optional[list[str]] = None
        # observability tap: called with each appended record (the usage
        # meter bills log bytes here); suppressed during import_records so
        # migrated lines are not billed twice.
        self.on_append = None

    def append(self, rec: LogRecord):
        off_g = len(self.records)
        self.records.append(rec)
        pool = self._by_job[rec.job_id]
        off_j = len(pool)
        pool.append(rec)
        job_post = self._job_postings[rec.job_id]
        for tok in set(_TOKEN_RE.findall(rec.line)):
            arr = self._postings.get(tok)
            if arr is None:
                self._postings[tok] = arr = array("q")
                self._vocab = self._rvocab = None  # new token: vocab dirty
            arr.append(off_g)
            jarr = job_post.get(tok)
            if jarr is None:
                job_post[tok] = jarr = array("q")
            jarr.append(off_j)
        if self.on_append is not None:
            self.on_append(rec)

    # -- query planning ---------------------------------------------------
    @staticmethod
    def _plan(query: str) -> Optional[list[tuple[str, str]]]:
        """Compile a substring query into token constraints.

        A token strictly inside the query is delimiter-bounded on both
        sides, so any matching line must contain it as a complete token
        (``exact``). A token touching the query's start may continue to
        the left inside the line (``suffix``: some line token ends with
        it); one touching the end may continue right (``prefix``); a token
        spanning the whole query may continue both ways (``substr``).
        ``None`` = no token to index on (fall back to scanning).
        """
        matches = list(_TOKEN_RE.finditer(query))
        if not matches:
            return None
        cons = []
        for m in matches:
            bounded_l = m.start() > 0
            bounded_r = m.end() < len(query)
            if bounded_l and bounded_r:
                cons.append(("exact", m.group()))
            elif bounded_l:
                cons.append(("prefix", m.group()))
            elif bounded_r:
                cons.append(("suffix", m.group()))
            else:
                cons.append(("substr", m.group()))
        return cons

    def _ensure_vocab(self):
        # Concurrent searches share the shard's read lock, so two threads
        # may rebuild at once: publish _vocab LAST — readers gate on it,
        # and seeing it non-None must imply _rvocab is usable too.
        if self._vocab is None:
            rvocab = sorted(t[::-1] for t in self._postings)
            vocab = sorted(self._postings)
            self._rvocab = rvocab
            self._vocab = vocab

    def _vocab_match(self, kind: str, text: str) -> list[str]:
        """All indexed tokens compatible with one non-exact constraint."""
        self._ensure_vocab()
        if kind == "prefix":
            lo = bisect_left(self._vocab, text)
            hi = bisect_left(self._vocab, text + "\uffff")
            return self._vocab[lo:hi]
        if kind == "suffix":
            rt = text[::-1]
            lo = bisect_left(self._rvocab, rt)
            hi = bisect_left(self._rvocab, rt + "\uffff")
            return [t[::-1] for t in self._rvocab[lo:hi]]
        return [t for t in self._vocab if text in t]  # substr

    def _candidates(self, query: str,
                    job_id: Optional[str]) -> Optional[list[int]]:
        """Sorted candidate offsets (into the global or per-job pool) that
        can possibly match ``query``; ``None`` = no usable constraint."""
        cons = self._plan(query)
        if cons is None:
            return None
        postings = (self._postings if job_id is None
                    else self._job_postings.get(job_id, {}))
        infos: list[tuple[int, list]] = []  # (candidate count, posting arrays)
        for kind, text in cons:
            if kind == "exact":
                arr = postings.get(text)
                if not arr:
                    return []
                infos.append((len(arr), [arr]))
            else:
                arrs = [postings[tok]
                        for tok in self._vocab_match(kind, text)
                        if tok in postings]
                est = sum(len(a) for a in arrs)
                if est == 0:
                    return []
                infos.append((est, arrs))
        # Every candidate gets the exact ``query in line`` check anyway, so
        # constraints are only a pre-filter: seed from the most selective
        # one and intersect only peers of comparable size — materialising a
        # token that appears on every line would cost more than it prunes.
        infos.sort(key=lambda x: x[0])
        base: set[int] = set()
        for a in infos[0][1]:
            base.update(a)
        for est, arrs in infos[1:]:
            if est > 4 * len(base):
                break
            s: set[int] = set()
            for a in arrs:
                s.update(a)
            base.intersection_update(s)
            if not base:
                return []
        return sorted(base)

    # -- tenant rebalancing (repro.api.admin migrations) -------------------
    def export_job(self, job_id: str, since: int = 0) -> list[dict]:
        """One job's records past a per-job watermark, as JSON-able dicts.
        ``since + len(result)`` is the watermark for the next delta export.
        Call under the shard's lock for a consistent cut."""
        return [{"ts": r.ts, "job_id": r.job_id, "learner": r.learner,
                 "line": r.line}
                for r in self._by_job.get(job_id, [])[since:]]

    def import_records(self, recs: list[dict]):
        """Append exported records into THIS index (normal ``append`` path,
        so the inverted index stays consistent). Per-job offsets — the log
        cursors clients hold — are preserved because deltas arrive in
        order and start where the previous import stopped."""
        hook, self.on_append = self.on_append, None
        try:  # migrated lines were billed on their source shard already
            for d in recs:
                self.append(LogRecord(**d))
        finally:
            self.on_append = hook

    def purge_jobs(self, job_ids) -> int:
        """Tombstone every record of ``job_ids`` (post-cutover source
        cleanup). The global record list keeps its LENGTH and positions —
        records are flagged in place — so the integer scan-offset cursors
        other tenants hold against this shard stay valid. Cost is
        O(purged jobs' records), not a scan of the whole shard (the purge
        runs under BOTH shards' write locks at cutover): the per-job
        pools reference the same record objects, so flagging through them
        tombstones the global list too. Returns the tombstone count."""
        n = 0
        for jid in set(job_ids):
            for rec in self._by_job.pop(jid, []):
                rec.purged = True  # visible through self.records as well
                n += 1
            self._job_postings.pop(jid, None)
        return n

    # -- search -----------------------------------------------------------
    def search(self, query: str, job_id: Optional[str] = None) -> list[LogRecord]:
        return self.search_page(query, job_id=job_id)[0]

    def stream(self, job_id: str) -> list[str]:
        return [r.line for r in self._by_job.get(job_id, [])]

    def stream_page(self, job_id: str, cursor: int = 0,
                    limit: Optional[int] = None
                    ) -> tuple[list[str], Optional[int]]:
        """One page of a job's log stream. The cursor is the offset into the
        per-job record sequence; ``None`` next-cursor means exhausted."""
        recs = self._by_job.get(job_id, [])
        if limit is None:
            return [r.line for r in recs[cursor:]], None
        page = recs[cursor:cursor + limit]
        nxt = cursor + len(page)
        return [r.line for r in page], (nxt if nxt < len(recs) else None)

    def search_page(self, query: str, job_id: Optional[str] = None,
                    cursor: int = 0, limit: Optional[int] = None,
                    allow=None) -> tuple[list[LogRecord], Optional[int]]:
        """Paginated substring search. The cursor is the scan offset into
        the (append-only) record sequence — exactly the pre-index meaning,
        so cursors minted before an index rebuild stay valid. ``allow``
        (``job_id -> bool``) optionally restricts matches (tenant scoping
        in the gateway)."""
        pool = self.records if job_id is None else self._by_job.get(job_id, [])
        cands = self._candidates(query, job_id)
        if cands is None:  # no indexable token: legacy linear scan
            out: list[LogRecord] = []
            i = cursor
            while i < len(pool):
                r = pool[i]
                i += 1
                if not getattr(r, "purged", False) and query in r.line \
                        and (allow is None or allow(r.job_id)):
                    out.append(r)
                    if limit is not None and len(out) >= limit:
                        break
            return out, (i if i < len(pool) else None)
        out = []
        for off in cands[bisect_left(cands, cursor):]:
            r = pool[off]  # purged = tombstone of a migrated-away job
            if not getattr(r, "purged", False) and query in r.line \
                    and (allow is None or allow(r.job_id)):
                out.append(r)
                if limit is not None and len(out) >= limit:
                    # the scan would have stopped right after this record
                    return out, (off + 1 if off + 1 < len(pool) else None)
        return out, None


class LogCollector:
    """Per-job helper container: tails learner logs into the index.

    Keeps per-learner byte offsets so a crash+restart never duplicates or
    drops lines (offsets themselves live on the volume → survive crashes).
    """

    def __init__(self, job_id: str, n_learners: int, volume: JobVolume,
                 index: LogIndex, clock):
        self.job_id = job_id
        self.n_learners = n_learners
        self.volume = volume
        self.index = index
        self.clock = clock
        self.alive = True

    def crash(self):
        self.alive = False

    def restart(self):
        self.alive = True

    def tick(self):
        if not self.alive:
            return
        try:
            for k in range(self.n_learners):
                content = self.volume.read(f"logs/learner-{k}") or ""
                off_raw = self.volume.read(f".collector/offset-{k}")
                offset = int(off_raw) if off_raw else 0
                new = content[offset:]
                if not new:
                    continue
                for line in new.splitlines():
                    self.index.append(LogRecord(self.clock.now(), self.job_id,
                                                k, line))
                self.volume.write(f".collector/offset-{k}", str(len(content)))
        except IOError:
            pass


class MetricsService:
    """Platform-level metrics: job throughput, component failure counters,
    cluster utilization samples."""

    def __init__(self, clock):
        self.clock = clock
        self.job_metrics: dict[str, list] = defaultdict(list)
        self.counters: dict[str, int] = defaultdict(int)
        self.util_samples: list[tuple[float, float]] = []

    def record_job(self, job_id: str, **metrics):
        self.job_metrics[job_id].append((self.clock.now(), metrics))

    def bump(self, counter: str, n: int = 1):
        self.counters[counter] += n

    def sample_utilization(self, util: float):
        self.util_samples.append((self.clock.now(), util))
