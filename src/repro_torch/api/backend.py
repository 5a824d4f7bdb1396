"""Backend: one FfDLPlatform shard behind the gateway tier (FfDL §3.2-3.3).

The paper's API layer is stateless and *independently scalable* from the
backend microservices it fronts: the REST contract survives backend
re-architecture. This module is the seam that makes that true here — a
:class:`Backend` wraps one ``FfDLPlatform`` shard (its own metastore,
scheduler, cluster, log index) with the two pieces of state the gateway
tier needs:

  * **a per-shard readers-writer lock** (:class:`RWLock`). The simulation
    core is single-threaded, so every v1 verb must hold its shard's lock —
    but *only* its shard's lock, and reads share it. A ``status`` on
    shard A never serializes behind a ``submit`` on shard B, and two
    ``list_jobs`` on the same shard run concurrently. This replaces the
    PR-2 global ``server.lock`` that funnelled every HTTP handler thread
    through one mutex;
  * **health state**. A crashed shard (``crash()``) answers
    ``UNAVAILABLE`` for *its* tenants only — the router keeps sending
    every other tenant to their own healthy shards, and the load
    balancer's replica crash-masking composes on top unchanged.

:class:`AllShardsLock` is the compatibility bridge for code that used the
old global lock (``with server.lock: platform.tick()``): it acquires every
shard's write lock in shard order (a total order, so it cannot deadlock
against verb handlers, which hold at most one shard lock at a time).
"""

from __future__ import annotations

import threading
from contextlib import ExitStack, contextmanager

from repro_torch.core.faults import DeadlineExceeded, ShardBreaker, remaining


class RWLock:
    """Writer-preferring readers-writer lock.

    Readers share; a writer excludes everyone. Writer preference (readers
    queue behind a *waiting* writer) keeps submits from starving under the
    read-heavy traffic this lock exists to scale.

    Acquisition waits are **deadline-bounded**: when the calling thread
    carries an ambient deadline (the gateway wraps every v1 verb in a
    :func:`repro_torch.core.faults.deadline_scope`), a wait that outlives the
    budget raises :class:`DeadlineExceeded` instead of blocking forever.
    This is the defense that matters against a *gray* shard: a hung tick
    holds the write lock, and without the bound every verb on the shard
    would stall indefinitely at lock acquisition.

    ``shared_reads=False`` degrades reads to exclusive acquisitions — the
    pre-federation single-lock behaviour, kept so ``benchmarks/api_tier.py``
    can measure the read/write split against an honest baseline.
    """

    def __init__(self, shared_reads: bool = True):
        self.shared_reads = shared_reads
        # Stable label for the lock-order witness (repro.analysis.witness):
        # owners set it ("shard:0", ...) so witnessed acquisition-graph
        # edges read as topology, not object ids.
        self.name = None  # type: str | None
        self._cond = threading.Condition()
        self._readers = 0
        self._writer_active = False
        self._writers_waiting = 0
        # benchmark introspection: proves reads actually overlapped
        self.stats = {"reads": 0, "writes": 0, "max_concurrent_readers": 0}

    def _wait(self):
        """One condition wait, bounded by the thread's ambient deadline."""
        rem = remaining()
        if rem is None:
            self._cond.wait()
        elif rem <= 0:
            raise DeadlineExceeded("lock wait exceeded the deadline budget")
        else:
            self._cond.wait(rem)

    @contextmanager
    def read_locked(self):
        if not self.shared_reads:
            with self.write_locked():
                yield
            return
        with self._cond:
            while self._writer_active or self._writers_waiting:
                self._wait()
            self._readers += 1
            self.stats["reads"] += 1
            if self._readers > self.stats["max_concurrent_readers"]:
                self.stats["max_concurrent_readers"] = self._readers
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write_locked(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer_active or self._readers:
                    self._wait()
            except BaseException:
                # readers queued behind this (now aborted) writer would
                # otherwise sleep until the next unrelated notify
                self._cond.notify_all()
                raise
            finally:
                self._writers_waiting -= 1
            self._writer_active = True
            self.stats["writes"] += 1
        try:
            yield
        finally:
            with self._cond:
                self._writer_active = False
                self._cond.notify_all()


class Backend:
    """One platform shard + its lock + its health state.

    ``platform`` is duck-typed (an ``FfDLPlatform``); the gateway reaches
    its metastore/log-index/admission/cluster through ``backend.platform``
    while holding ``backend.lock``.
    """

    def __init__(self, shard_id: str, platform, shared_reads: bool = True):
        self.shard_id = shard_id
        self.platform = platform
        self.lock = RWLock(shared_reads=shared_reads)
        self.lock.name = f"shard:{shard_id}"
        self.alive = True
        # operator cordon (v2 admin plane): a cordoned shard keeps serving
        # its resident tenants but accepts no NEW tenant placements and no
        # migration destinations. drain = migrate everyone off, then cordon.
        self.cordoned = False
        # software version the shard runs; the autonomous operator's rolling
        # upgrades bump it wave by wave via restart(version=...).
        self.version = "v0"
        # retired: fenced out of the fleet by the operator after a
        # scale-down drain. Stays in router.backends (the hash modulus and
        # composite cursors must not shift) but the federation stops
        # ticking it and the operator excludes its capacity.
        self.retired = False
        # gray-failure quarantine: per-shard circuit breaker. The gateway
        # records one outcome per v1 verb and checks allow() at shard
        # selection; an open breaker answers fast UNAVAILABLE exactly like
        # a dead shard (shard_down details), so a wedged-but-alive shard
        # cannot stall its tenants.
        self.breaker = ShardBreaker()

    # -- shard lifecycle (chaos) ------------------------------------------
    def crash(self):
        """Down the whole shard: every verb routed here answers
        UNAVAILABLE until restart. Other shards' tenants are unaffected."""
        self.alive = False

    def restart(self, version: str = None):
        self.alive = True
        if version is not None:
            self.version = version
        # a restart clears the gray-failure presumption; if the shard is
        # still wedged the breaker re-opens within failure_threshold calls
        self.breaker.reset()

    # -- operator lifecycle (v2 admin plane) ------------------------------
    def cordon(self):
        self.cordoned = True

    def uncordon(self):
        self.cordoned = False

    def retire(self):
        """Fence the shard out of the fleet (cordon + stop ticking). The
        shard object stays addressable so existing composite cursors and
        the tenant-hash modulus remain valid."""
        self.cordoned = True
        self.retired = True

    def read_locked(self):
        return self.lock.read_locked()

    def write_locked(self):
        return self.lock.write_locked()

    def __repr__(self):
        state = "up" if self.alive else "DOWN"
        return f"Backend({self.shard_id}, {state})"


class AllShardsLock:
    """Every shard's write lock, acquired in shard order.

    Drop-in for the old global ``server.lock``: external code that ticks a
    platform from another thread (`with server.lock: platform.tick()`)
    still excludes every in-flight verb. Verb handlers themselves hold at
    most one shard lock and never acquire a second while holding it, so
    this total-order acquisition cannot deadlock against them.
    """

    def __init__(self, router):
        self.router = router
        self._stack = None

    def __enter__(self):
        stack = ExitStack()
        try:
            for backend in self.router.backends:
                stack.enter_context(backend.lock.write_locked())
        except BaseException:
            stack.close()
            raise
        self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        stack.close()
        return False
